"""Model FLOPs of the window's work over the traced window at the
float32-exact peak (165 TFLOP/s: a float32 product as three TF32 products at
495), in percent.  The FLOPs are the benchmark's count from the
configuration and each call's own shapes (``portbench/counts.py``), whatever
implements them."""


def read(m):
    flops = sum(m.rec["flops"])
    if not flops:
        return None
    return 100.0 * flops / (m.trace.window_s() * m.peaks["f32_exact_flops_per_s"])
