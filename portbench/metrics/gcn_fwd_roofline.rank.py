"""Kernel 1 (``gcn_layer``, the float32 form) in ``Ranker.rank`` against its
bound: the layer's products counted from its [B, C, D] shape as three TF32
products at the TF32 rate, or its bytes at the memory rate, whichever is
larger, over the device time of every launch the layer makes
(``split_w_f32``, the ``gcn_rows_f32`` launches and the memset between
them)."""

import re

from portbench import counts

LAUNCHES = re.compile(r"gcn_rows_f32|split_w_f32")
MEMSET = "Memset"


def layer_seconds(trace) -> float:
    """Kernel 1's launches, and each memset that sits between two of them."""
    ops, total = trace.dev, 0.0
    for i, (name, a, b) in enumerate(ops):
        if LAUNCHES.search(name):
            total += b - a
        elif MEMSET in name and 0 < i < len(ops) - 1 and LAUNCHES.search(ops[i - 1][0]) \
                and LAUNCHES.search(ops[i + 1][0]):
            total += b - a
    return total / 1e6


def read(m):
    layers = m.trace.count(r"split_w_f32")
    if not layers:
        return None
    cfg = m.run.config
    n = cfg["num_gcn_layers"]
    calls = [s for s in m.rec["shapes"] if s.get("gcn", True)]
    if layers != n * len(calls):
        raise RuntimeError(f"{layers} float32 GCN layers traced for {len(calls)} forwards")
    D = cfg["gcn_embed_dim"]
    bound = sum(n * counts.bound_s(counts.gcn_layer_bytes(s["B"], s["C"], D, "float32"),
                                   counts.gcn_layer_flops(s["B"], s["C"], D), "float32", m.peaks)
                for s in calls)
    return 100.0 * bound / layer_seconds(m.trace)
