"""Plain PyTorch reference of DRIN, the Dynamic Relation Interactive Network
(Xing et al., ACM MM 2023, arXiv 2310.05589; github.com/starreeze/drin,
``model.py``), at the configuration of ``configs/drin-wikimel.json``.

Float32 throughout, with TF32 off (:func:`precision`), no kernels, no cache,
no batching tricks.  It imports nothing of the program: the weights are a
dict of tensors under the upstream module names (:func:`param_shapes`), made
by the benchmark from the seed, and the entity rows are worked out again
from the raw tables, int8 quantization included (:func:`quantize_rows`).

The model, per mention and its C candidates:

* vertices: mt = W_mt · mean(text[start:end]); mi = W_mi · mean(regions);
  et = W_et · pooled entity text; ei = W_ei · mean(entity image);
* edges: tt = cos(mean(text[start:end]), entity CLS); ti = mtei / 100;
  it = miet / 100; ii = the score-weighted mean of the object-pair cosines;
* each GCN layer: every vertex takes its own value plus its neighbours
  weighted by the edges (a mention averages over the C candidates), then
  gelu(LayerNorm(W_h ·)); every edge becomes
  sigmoid(mean_D(W_u(u) ⊙ W_v(v)) + e) from the layer's old vertices;
* score = cos(mt, et) after the last layer.

The program computes the edge update folded, ((u·Ku + bu)·Kvᵀ·v +
(u·Ku + bu)·bv) / D, which is the same sum in another order; this reference
keeps the published form.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.nn import functional as F


def param_shapes(cfg: dict) -> dict:
    """name -> (shape, init): ``("uniform", bound)`` for a linear's weight
    and bias (torch's default bound 1/sqrt(fan_in)), ``("const", 1.0)`` and
    ``("const", 0.0)`` for a LayerNorm's scale and bias."""
    D, Dg, Dr = cfg["bert_embed_dim"], cfg["gcn_embed_dim"], cfg["resnet_embed_dim"]
    out = {}

    def linear(name, fan_in, fan_out):
        out[f"{name}.weight"] = ((fan_out, fan_in), ("uniform", fan_in ** -0.5))
        out[f"{name}.bias"] = ((fan_out,), ("uniform", fan_in ** -0.5))

    linear("vertex_encoder.mention_text_encoder.final_layer.linear", D,
           cfg["mention_final_output_dim"])
    linear("vertex_encoder.entity_text_encoder.final_layer", D, cfg["entity_final_output_dim"])
    linear("vertex_encoder.mention_image_linear", Dr, Dg)
    linear("vertex_encoder.entity_image_linear", Dr, Dg)
    for i in range(cfg["num_gcn_layers"]):
        for w in ("w_h", "w_u", "w_v"):
            linear(f"gcn_layers.{i}.{w}", Dg, Dg)
        out[f"gcn_layers.{i}.layer_norm.weight"] = ((Dg,), ("const", 1.0))
        out[f"gcn_layers.{i}.layer_norm.bias"] = ((Dg,), ("const", 0.0))
    return out


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 products as float32 (``tf32=False``, the reference) or in one
    TF32 pass (``tf32=True``, the control a step below the configuration's
    float32)."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


def quantize_rows(x: torch.Tensor, lead: int = 1):
    """Per-row max-abs int8 of the served store: one float32 scale per row
    (``lead=2``: per row and slot).  Returns (q as float32, scale) with
    q * scale the row as served; an all-zero row gets scale 1 / 127."""
    flat = x.reshape(x.shape[:lead] + (-1,)).float()
    s = flat.abs().amax(-1)
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(flat / s[..., None] * 127.0), -127, 127)
    return q.reshape(x.shape), s / 127.0


def served_rows(rows: dict, quantized: bool, batch_dims: int = 2) -> dict:
    """The entity rows a request reads ([B, C, ...] for ``batch_dims=2``), as
    the store serves them: the raw float32 rows, or their int8 form
    dequantized (text per row and slot)."""
    if not quantized:
        return {k: v.float() for k, v in rows.items()}
    out = {"entity_object_score": rows["entity_object_score"].float()}
    for key, slot in (("entity_text_feature", 1), ("entity_image_feature", 0),
                      ("entity_object_feature", 0)):
        q, s = quantize_rows(rows[key], batch_dims + slot)
        out[key] = q * s.reshape(s.shape + (1,) * (q.ndim - s.ndim))
    return out


def linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def span_mean(x: torch.Tensor, begin: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Mean of x[b, begin[b]:end[b]]; an empty span gives 0."""
    pos = torch.arange(x.shape[1], device=x.device)
    m = ((pos[None] >= begin[:, None]) & (pos[None] < end[:, None])).float()
    return (m[..., None] * x).sum(1) / m.sum(1, keepdim=True).clamp(min=1.0)


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1) / torch.clamp(a.norm(dim=-1) * b.norm(dim=-1), min=1e-8)


def object_similarity(mo, ms, eo, es):
    """sum_ij cos(mo_i, eo_j) ms_i es_j / (sum_ij ms_i es_j + 1e-9): mo [B, Tm,
    D], ms [B, Tm], eo [B, C, Te, D], es [B, C, Te] -> [B, C]."""
    cos = cosine(mo[:, None, :, None, :], eo[:, :, None, :, :])  # [B, C, Tm, Te]
    w = ms[:, None, :, None] * es[:, :, None, :]
    return (cos * w).sum((-1, -2)) / (w.sum((-1, -2)) + 1e-9)


def gcn_layer(p: dict, i: int, vertexes, edges, C: int):
    mt, mi, et, ei = vertexes
    tt, ti, it, ii = edges
    col = lambda e: e[..., None]
    aggs = [mt + (col(tt) * et).sum(1) / C + (col(ti) * ei).sum(1) / C,
            mi + (col(it) * et).sum(1) / C + (col(ii) * ei).sum(1) / C,
            et + col(tt) * mt[:, None] + col(it) * mi[:, None],
            ei + col(ti) * mt[:, None] + col(ii) * mi[:, None]]
    name = f"gcn_layers.{i}"
    ln = (p[f"{name}.layer_norm.weight"], p[f"{name}.layer_norm.bias"])
    new_v = [F.gelu(F.layer_norm(linear(p, f"{name}.w_h", a), a.shape[-1:], *ln, eps=1e-5))
             for a in aggs]
    new_e = []
    for e, u, v in zip(edges, (mt, mt, mi, mi), (et, ei, et, ei)):
        fu, fv = linear(p, f"{name}.w_u", u), linear(p, f"{name}.w_v", v)
        new_e.append(torch.sigmoid((fu[:, None] * fv).mean(-1) + e))
    return new_v, new_e


def forward(p: dict, batch: dict) -> torch.Tensor:
    """Scores [B, C] of a batch: the mention fields, the served entity rows
    (:func:`served_rows`) and the two CLIP logits."""
    text, start, end = batch["mention_text_feature"], batch["mention_start_pos"], \
        batch["mention_end_pos"]
    span = span_mean(text, start, end)
    et_text = batch["entity_text_feature"]  # [B, C, 2, D]: (pooled, CLS)
    mt = linear(p, "vertex_encoder.mention_text_encoder.final_layer.linear", span)
    mi = linear(p, "vertex_encoder.mention_image_linear", batch["mention_image_feature"].mean(1))
    et = linear(p, "vertex_encoder.entity_text_encoder.final_layer", et_text[:, :, 0])
    ei = linear(p, "vertex_encoder.entity_image_linear", batch["entity_image_feature"].mean(-2))
    C = et.shape[1]
    edges = [cosine(span[:, None], et_text[:, :, 1]),
             batch["mtei_similarity"] / 100.0,
             batch["miet_similarity"] / 100.0,
             object_similarity(batch["mention_object_feature"], batch["mention_object_score"],
                               batch["entity_object_feature"].mean(-2),
                               batch["entity_object_score"])]
    vertexes = [mt, mi, et, ei]
    layers = len({k.split(".")[1] for k in p if k.startswith("gcn_layers.")})
    for i in range(layers):
        vertexes, edges = gcn_layer(p, i, vertexes, edges, C)
    return cosine(vertexes[0][:, None], vertexes[2])


def triplet_loss(scores: torch.Tensor, answer: torch.Tensor, margin: float) -> torch.Tensor:
    """The margin ranking loss with in-batch negatives: the gold score of
    mention i against every candidate score of the batch, averaged.  The
    appended answer column (C = candidates + 1) is left out."""
    s = scores[:, : answer.shape[1]]
    gold = (s * answer).sum(-1)  # 0 where the answer is absent
    return torch.clamp(s[None] - gold[:, None, None] + margin, min=0.0).mean()


class Adam:
    """torch.optim.Adam's update written out (lr, betas (0.9, 0.999), eps
    1e-8, no weight decay)."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(p0: dict, batches, margin: float, lr: float, tf32: bool = False):
    """Steps of the triplet loss under Adam from ``p0`` over ``batches``:
    (losses, the first step's gradients, the parameters after the last)."""
    params = {k: v.detach().clone().float() for k, v in p0.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    with precision(tf32):
        for batch in batches:
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = triplet_loss(forward(leaves, batch), batch["answer"], margin)
            # the last layer's new edges reach no score: their weights get no
            # gradient, and Adam leaves them as they are
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {k: g for k, g in zip(leaves, grads) if g is not None}
            if first is None:
                first = {k: grads[k].detach().clone() if k in grads else torch.zeros_like(v)
                         for k, v in params.items()}
            opt.step(params, grads)
            losses.append(float(loss.detach()))
    return losses, first, params
