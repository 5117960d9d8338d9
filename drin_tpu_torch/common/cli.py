# -*- coding: utf-8 -*-
"""CLI config overrides: ``key=value`` pairs with python-literal parsing
(the port's own copy of ``drin_tpu/common/cli.py``)."""

from __future__ import annotations

import ast


def parse_overrides(argv) -> dict:
    out = {}
    for arg in argv:
        if arg.startswith("--"):
            arg = arg[2:]
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got: {arg!r}")
        k, v = arg.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            low = v.lower()
            out[k] = {"true": True, "false": False, "none": None}.get(low, v)
    return out
