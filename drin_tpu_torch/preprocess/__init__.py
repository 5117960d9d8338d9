# -*- coding: utf-8 -*-
"""Offline preprocessing pipeline: raw data -> .npy feature store (port of
``drin_tpu/preprocess``).  Four stages, run in this order:

  python -m drin_tpu_torch.preprocess prepare   # raw JSON/TSV -> intermediate (host only)
  python -m drin_tpu_torch.preprocess bert      # frozen BERT text features
  python -m drin_tpu_torch.preprocess resnet    # frozen ResNet image/object features
  python -m drin_tpu_torch.preprocess clip      # frozen CLIP cross-modal similarities

or all four with ``all``; each takes ``key=value`` config overrides and
``device=cuda`` (the default) or ``device=cpu``.
"""
