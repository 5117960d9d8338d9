"""Encoders (port of ``drin_tpu/encoders``): BERT, which also runs inside
the online forward pass, and the frozen preprocessing encoders ResNet and
CLIP, with checkpoint loading for all three.  The Faster R-CNN detector is
not ported yet (ROADMAP item 8)."""
