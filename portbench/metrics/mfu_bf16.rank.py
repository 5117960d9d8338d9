"""Model FLOPs of the window's work over the traced window at the bf16 peak
(989 TFLOP/s), in percent: the whole step's share for a cell whose
configuration computes in bfloat16 (``mfu.rank`` holds float32 cells to the
float32-exact peak).  The FLOPs are the benchmark's count from the
configuration and each call's own shapes (``rec["flops"]``), whatever
implements them."""


def read(m):
    flops = sum(m.rec["flops"])
    if not flops:
        return None
    return 100.0 * flops / (m.trace.window_s() * m.peaks["bf16_flops_per_s"])
