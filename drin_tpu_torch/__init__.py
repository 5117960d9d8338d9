# -*- coding: utf-8 -*-
"""drin-tpu-torch: the PyTorch / CUDA (Hopper) port of ``drin_tpu``.

The JAX package ``drin_tpu`` stays the reference; this package mirrors its
module layout so each counterpart is found at the same path, and imports
nothing of it (``common/`` holds the port's own configuration).  Importing it
costs nothing: no CUDA, no kernel build (kernels build at first CUDA use,
``drin_tpu_torch.ops.cuda._build``).

Common entry points:

    from drin_tpu_torch import make_config, get_model
    from drin_tpu_torch.serve import Ranker
"""

__version__ = "0.1.0"


def __getattr__(name):  # lazy: keep `import drin_tpu_torch` free of torch cost
    if name == "make_config":
        from drin_tpu_torch.common.config import make_config

        return make_config
    if name == "Config":
        from drin_tpu_torch.common.config import Config

        return Config
    if name == "get_model":
        from drin_tpu_torch.models import get_model

        return get_model
    raise AttributeError(name)
