"""The SSD scan kernel (``ssd_fwd_bf16``, ``csrc/ssd_scan.cu``) in the
granite tower's ``Ranker.rank`` against its bound: per launch, one Mamba-2
layer over a pass's sequences (a call's mention pass [B, Lm] and its
entity pass [B·S, L]), its products as bf16 at the bf16 rate or its bytes
at the memory rate, whichever is larger (``portbench/counts_granite.py``),
summed over the launches, over the kernel's device time."""

from portbench import counts_granite

KERNEL = r"ssd_fwd_bf16"


def read(m):
    ops = m.trace.ops(KERNEL)
    if not ops:
        return None
    cfg = m.run.config
    layers = counts_granite.mamba_layers(cfg)
    passes = [p for s in m.rec["shapes"] for p in ((s["B"], s["Lm"]), (s["B"] * s["S"], s["L"]))]
    if len(ops) != layers * len(passes):
        raise RuntimeError(f"{len(ops)} scan launches traced, {layers} x {len(passes)} tower "
                           "passes expected")
    bound = sum(layers * counts_granite.ssd_bound_s(cfg, n, L, m.peaks) for n, L in passes)
    return 100.0 * bound / m.trace.seconds(KERNEL)
