"""``python -m drin_tpu_torch.train key=value ...``: see :mod:`drin_tpu_torch.train.cli`."""

from drin_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
