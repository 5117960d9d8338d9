"""Operations and bytes of the granite-4.0-h-micro text tower and of its SSD
scan kernel (``csrc/ssd_scan.cu``), counted from a configuration and a
pass's shapes, as ``counts.py`` counts the other kernels and models.

The scan's operations are the products its mathematics needs for one layer
of ``n`` sequences of ``L`` tokens, in chunks of ``Q`` (the last one
shorter): inside a chunk, the scores C_t . B_s for s <= t, once (one group
shares them over the heads), and per head their weighted sum over x; per
head, the carried state's term C . H^T in every chunk after the first and
the state's update x^T . B in every chunk before the last.  Its bytes: x,
B, C and dt read once, A and D read, y written once; the carried state
stays on the chip (the kernel keeps it in registers), so it adds none.

The tower's model FLOPs count its products: every linear, the attention
products on the causal side (q . k for s <= t and the weighted sum of v),
and the scan's products as above.  The conv, the norms and the
elementwise work are left out, as ``counts.py`` leaves them out.
"""

from __future__ import annotations

from portbench import counts


def _chunks(L: int, Q: int):
    return [min(Q, L - t0) for t0 in range(0, L, Q)]


def ssd_flops(cfg: dict, n: int, L: int) -> float:
    """One Mamba-2 layer's scan over ``n`` sequences of ``L`` tokens."""
    H, P, S, Q = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], \
        cfg["mamba_chunk_size"]
    sizes = _chunks(L, Q)
    pairs = sum(q * (q + 1) // 2 for q in sizes)  # (t, s) with s <= t inside a chunk
    inside = 2.0 * pairs * S + H * 2.0 * pairs * P
    carried = H * 2.0 * sum(sizes[1:]) * S * P
    update = H * 2.0 * sum(sizes[:-1]) * P * S
    return n * (inside + carried + update)


def ssd_bytes(cfg: dict, n: int, L: int) -> float:
    """x, B, C (bf16) and dt (float32) read once, A and D read, y written."""
    H, P, S = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    tokens = n * L
    return tokens * (2 * H * P + 2 * 2 * S + 4 * H) + 2 * 4 * H + tokens * 2 * H * P


def ssd_bound_s(cfg: dict, n: int, L: int, pk: dict) -> float:
    """The least time for one layer's scan: the operations as bf16 products
    or the bytes, whichever is larger."""
    return counts.bound_s(ssd_bytes(cfg, n, L), ssd_flops(cfg, n, L), "bfloat16", pk)


def mamba_layers(cfg: dict) -> int:
    return sum(kind == "mamba" for kind in cfg["layer_types"])


def tower_flops(cfg: dict, n: int, L: int) -> float:
    """The tower's products over ``n`` sequences of ``L`` tokens."""
    D, F_ = cfg["hidden_size"], cfg["shared_intermediate_size"]
    H, P, S = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    Hk, hd = cfg["num_key_value_heads"], D // cfg["num_attention_heads"]
    lin = counts._linear
    tokens = n * L
    mlp = lin(tokens, D, 2 * F_) + lin(tokens, F_, D)
    d_inner = H * P
    mamba = lin(tokens, D, 2 * d_inner + 2 * S + H) + lin(tokens, d_inner, D) \
        + ssd_flops(cfg, n, L)
    attention = lin(tokens, D, D + 2 * Hk * hd) + lin(tokens, D, D) \
        + n * 2 * (2.0 * D * L * (L + 1) / 2)
    n_mamba = mamba_layers(cfg)
    return cfg["num_hidden_layers"] * mlp + n_mamba * mamba \
        + (cfg["num_hidden_layers"] - n_mamba) * attention


def ghmfc_granite_flops(cfg: dict, B: int, Lm: int, S: int, L: int) -> float:
    """The tower over the B mention sentences of Lm tokens and the B·S zipped
    entity sentences of L tokens, the gated fusion over the mention's text
    (up to ``max_mention_sentence_len`` tokens) and its R image regions, and
    the entity linear over the C candidates (``counts.ghmfc_online_flops``
    with this tower in BERT's place)."""
    D, Dr, R = cfg["bert_embed_dim"], cfg["resnet_embed_dim"], cfg["resnet_num_region"]
    Lt = min(Lm, cfg["max_mention_sentence_len"])
    out = cfg["mention_final_output_dim"]
    fusion = (counts._cross_attention(Lt, R, D, Dr) + counts._cross_attention(R, Lt, Dr, D)
              + counts._linear(1, D, out) + counts._linear(1, Dr, out)
              + counts._linear(1, 2 * out, 2))
    C = cfg["num_candidates_data"] + 1
    return (tower_flops(cfg, B, Lm) + tower_flops(cfg, B * S, L) + B * fusion
            + counts._linear(B * C, D, cfg["entity_final_output_dim"]))
