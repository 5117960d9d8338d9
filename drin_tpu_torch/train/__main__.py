"""``python -m drin_tpu_torch.train key=value ...``: see :mod:`drin_tpu_torch.train.cli`.

The import stays under the ``__main__`` guard: the online dataset's spawn
workers import this module again, and must not pay for torch."""

if __name__ == "__main__":
    from drin_tpu_torch.train.cli import main

    main()
