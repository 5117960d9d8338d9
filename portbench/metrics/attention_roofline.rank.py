"""Kernel 3 (``attention``, the float32 forward ``attn_fwd_f32``) in the
online ``Ranker.rank`` against its bound: each launch's operations (Q·Kᵀ
and P·V) and bytes (q, k, v, the output and the mask) counted from its
[B·S, H, L, 64] shape, the operations as three TF32 products at the TF32
rate; the larger bound over the kernel's device time.  BERT takes the
kernel for sequences of 256 tokens or more: the zipped entity sentences,
one launch a layer."""

from portbench import counts

KERNEL = r"attn_fwd_f32"


def read(m):
    ops = m.trace.ops(KERNEL)
    if not ops:
        return None
    bert = m.run.config["bert"]
    H, n = bert["num_attention_heads"], bert["num_hidden_layers"]
    hd = bert["hidden_size"] // H
    launches = [s for s in m.rec["shapes"] if s["L"] >= 256 for _ in range(n)]
    if len(ops) != len(launches):
        raise RuntimeError(f"{len(ops)} attention launches traced, {len(launches)} expected")
    bound = sum(counts.bound_s(counts.attention_bytes(s["B"] * s["S"], H, s["L"], "float32", hd),
                               counts.attention_flops(s["B"] * s["S"], H, s["L"], hd),
                               "float32", m.peaks) for s in launches)
    return 100.0 * bound / m.trace.seconds(KERNEL)
