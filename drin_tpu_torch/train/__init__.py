"""Training: loss, metrics, step functions, the Trainer and the
``python -m drin_tpu_torch.train`` entry point (port of ``drin_tpu/train`` and
the root ``train.py``, one device)."""
