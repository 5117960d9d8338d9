"""Operations and bytes of the port's kernels and of its models, counted from
shapes (frozen from the bound arithmetic the port's chip smoke run prints).

A kernel's bound is the least time the card could take: its bytes over the
memory rate or its operations over the rate of their type, whichever is
larger.  A float32-accurate product on the tensor cores is three TF32
products (split precision), so float32 operations count three times at the
TF32 rate.  Bytes count each input read once and each output written once.

Model FLOPs count the products a model's mathematics needs for a batch,
whatever implements them: linears, the attention products, the GCN layers'
products and the object-pair dots.  Elementwise work, norms and reductions
are left out.
"""

from __future__ import annotations


def bound_s(nbytes: float, flops: float, dtype: str, pk: dict) -> float:
    """Seconds: max(bytes / memory rate, operations / rate); float32 as
    three TF32 products."""
    if dtype == "float32":
        t_ops = 3 * flops / pk["tf32_flops_per_s"]
    else:
        t_ops = flops / pk["bf16_flops_per_s"]
    return max(nbytes / pk["bytes_per_s"], t_ops)


def _size(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


# -- kernel 1: the fused GCN layer ------------------------------------------
def gcn_layer_flops(B: int, C: int, D: int) -> float:
    """x·W_hᵀ over the 2BC entity and 2B mention rows, and the edge fold's two
    products over the 2B mention rows."""
    return 2 * (2 * B * C + 2 * B) * D * D + 2 * 2 * (2 * B) * D * D


def gcn_layer_bytes(B: int, C: int, D: int, dtype: str) -> float:
    """The four vertex sets and four edges read and written, the dynamic
    layer's weights (W_h, W_u, W_v, their biases, the LayerNorm) read."""
    vertexes = 2 * B * D + 2 * B * C * D
    edges = 4 * B * C
    weights = 3 * D * D + 5 * D
    return (2 * (vertexes + edges) + weights) * _size(dtype)


# -- kernel 2: the gather with dequantization ------------------------------
def gather_bytes(rows: int, widths, out_dtype: str) -> float:
    """Each gathered row's int8 data (sub-rows of 128), a float32 scale a
    sub-row and its int32 index read once; the output written once.
    ``widths`` are the packed tables' row widths (DRIN: 2x768 text, 2048
    image, 2048 object)."""
    sub = sum(w // 128 for w in widths)
    return rows * (sub * 128 + sub * 4 + 4) + rows * sum(widths) * _size(out_dtype)


DRIN_SLAB = (2 * 768, 2048, 2048)


# -- kernel 3: the fused attention ------------------------------------------
def attention_flops(B: int, H: int, L: int, hd: int = 64) -> float:
    """The two products, Q·Kᵀ and P·V."""
    return 4 * L * L * hd * B * H


def attention_bytes(B: int, H: int, L: int, dtype: str, hd: int = 64) -> float:
    """q, k, v read, the output written, the additive mask read."""
    return (4 * B * H * L * hd + B * L) * _size(dtype)


# -- models --------------------------------------------------------------------
def _linear(rows: float, k: int, n: int) -> float:
    return 2.0 * rows * k * n


def drin_flops(cfg: dict, B: int, C: int, train: bool = False) -> float:
    """DRIN's products for B mentions and C candidates; with ``train`` the
    backward too: every linear's weight gradient, and the input gradient of
    the GCN layers, whose inputs come from parameters (the encoders' inputs
    are data)."""
    D, Dg, Dr = cfg["bert_embed_dim"], cfg["gcn_embed_dim"], cfg["resnet_embed_dim"]
    Tm, Te = cfg["mention_object_topk"], cfg["entity_object_topk"]
    encoders = (_linear(B, D, cfg["mention_final_output_dim"])
                + _linear(B * C, D, cfg["entity_final_output_dim"])
                + _linear(B, Dr, Dg) + _linear(B * C, Dr, Dg))
    objects = 2.0 * B * C * Tm * Te * Dr
    gcn = cfg["num_gcn_layers"] * gcn_layer_flops(B, C, Dg)
    fwd = encoders + objects + gcn
    return fwd + encoders + 2 * gcn if train else fwd


def bert_flops(bert: dict, rows: int, L: int) -> float:
    """BERT over ``rows`` sequences of ``L`` tokens: each layer's four
    projections and feed-forward per token, its attention products per
    sequence, and the pooler."""
    D, F_, n = bert["hidden_size"], bert["intermediate_size"], bert["num_hidden_layers"]
    per_token = _linear(1, D, 3 * D) + _linear(1, D, D) + _linear(1, D, F_) + _linear(1, F_, D)
    attention = 4.0 * L * L * D
    return n * (rows * L * per_token + rows * attention) + _linear(rows, D, D)


def _mha(Lq: int, Lk: int, E: int, kdim: int) -> float:
    return (_linear(Lq, E, E) + 2 * _linear(Lk, kdim, E) + 2 * 2.0 * Lq * Lk * E
            + _linear(Lq, E, E))


def _cross_attention(La: int, Lb: int, Da: int, Db: int) -> float:
    """a attends to b, the feed-forward, b's result attends back to a, the
    feed-forward (``CrossAttention``)."""
    return (_mha(La, Lb, Da, Db) + _linear(La, Da, Da)
            + _mha(La, La, Da, Da) + _linear(La, Da, Da))


def ghmfc_online_flops(cfg: dict, B: int, Lm: int, S: int, L: int) -> float:
    """BERT over the B mention sentences of Lm tokens and the B·S zipped
    entity sentences of L tokens, the gated fusion over the mention's text
    (up to ``max_mention_sentence_len`` tokens) and its R image regions, and
    the entity linear over the C candidates."""
    bert = cfg["bert"]
    D, Dr, R = cfg["bert_embed_dim"], cfg["resnet_embed_dim"], cfg["resnet_num_region"]
    Lt = min(Lm, cfg["max_mention_sentence_len"])
    out = cfg["mention_final_output_dim"]
    fusion = (_cross_attention(Lt, R, D, Dr) + _cross_attention(R, Lt, Dr, D)
              + _linear(1, D, out) + _linear(1, Dr, out) + _linear(1, 2 * out, 2))
    C = cfg["num_candidates_data"] + 1
    return (bert_flops(bert, B, Lm) + bert_flops(bert, B * S, L) + B * fusion
            + _linear(B * C, D, cfg["entity_final_output_dim"]))
