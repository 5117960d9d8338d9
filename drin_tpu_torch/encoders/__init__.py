"""Encoders (port of ``drin_tpu/encoders``): BERT, which also runs inside
the online forward pass, and the frozen preprocessing models ResNet, CLIP
and the Faster R-CNN detector, with checkpoint loading for all four."""
