"""Encoders that run inside the forward pass (port of ``drin_tpu/encoders``):
BERT.  The preprocessing encoders and checkpoint loading are not ported yet."""
