"""Plain PyTorch reference of GHMFC with online BERT (the gated hierarchical
multimodal fusion baseline of github.com/starreeze/drin, after Wang et al.,
"Multimodal Entity Linking with Gated Hierarchical Fusion and Contrastive
Training", SIGIR 2022), at the configuration of
``configs/ghmfc-online-wikimel.json``: bert-base (Devlin et al., arXiv
1810.04805) encodes the mention sentence and the candidates' texts inside
the request.

Float32 throughout with TF32 off (``drin.precision``), no kernels.  It
imports nothing of the program: the weights are a dict under the upstream
module names (:func:`param_shapes`).

* BERT (post-LN, exact gelu, LayerNorm eps 1e-12, the padding keys masked
  with float32's lowest value) over the mention sentence and, zipped mode,
  over S entity sentences, each ``[CLS] c1 [SEP] c2 [SEP] ...``;
* a candidate's vector is the mean of its tokens' states, from the token
  after the previous [SEP] (or after [CLS]) up to its own [SEP], then the
  entity linear;
* the mention: the gated fusion of its first ``max_mention_sentence_len``
  token states with its R image regions: two bidirectional cross attentions
  (text over regions, regions over text, 8 heads, post-LN 1e-5), max-pooled,
  each projected and passed through gelu, mixed by a 2-way softmax gate;
* the score is the cosine of the mention and each candidate vector.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from portbench import harness

_drin = harness.load_file_module("reference", "drin")
precision = _drin.precision
cosine = _drin.cosine


def param_shapes(cfg: dict) -> dict:
    """name -> (shape, init) as ``drin.param_shapes``; BERT's tensors
    N(0, 0.02) (its initializer, biases included), LayerNorms 1 and 0; the
    fusion's linears torch's default uniform, its attention in-projections
    Xavier-uniform with zero biases (``nn.MultiheadAttention``)."""
    b = cfg["bert"]
    D, F_, V, P = b["hidden_size"], b["intermediate_size"], b["vocab_size"], \
        b["max_position_embeddings"]
    out = {}
    normal = ("normal", 0.02)

    def ln(name, d):
        out[f"{name}.weight"] = ((d,), ("const", 1.0))
        out[f"{name}.bias"] = ((d,), ("const", 0.0))

    def bert_linear(name, fan_in, fan_out):
        out[f"{name}.weight"] = ((fan_out, fan_in), normal)
        out[f"{name}.bias"] = ((fan_out,), normal)

    out["bert.embeddings.word_embeddings.weight"] = ((V, D), normal)
    out["bert.embeddings.position_embeddings.weight"] = ((P, D), normal)
    out["bert.embeddings.token_type_embeddings.weight"] = ((b["type_vocab_size"], D), normal)
    ln("bert.embeddings.LayerNorm", D)
    for i in range(b["num_hidden_layers"]):
        pre = f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            bert_linear(f"{pre}.attention.self.{n}", D, D)
        bert_linear(f"{pre}.attention.output.dense", D, D)
        ln(f"{pre}.attention.output.LayerNorm", D)
        bert_linear(f"{pre}.intermediate.dense", D, F_)
        bert_linear(f"{pre}.output.dense", F_, D)
        ln(f"{pre}.output.LayerNorm", D)
    bert_linear("bert.pooler.dense", D, D)

    def linear(name, fan_in, fan_out):
        out[f"{name}.weight"] = ((fan_out, fan_in), ("uniform", fan_in ** -0.5))
        out[f"{name}.bias"] = ((fan_out,), ("uniform", fan_in ** -0.5))

    def mha(name, E, kdim):
        if kdim == E:
            out[f"{name}.in_proj_weight"] = ((3 * E, E), ("uniform", math.sqrt(6 / (4 * E))))
        else:
            out[f"{name}.q_proj_weight"] = ((E, E), ("uniform", math.sqrt(6 / (2 * E))))
            for n in ("k", "v"):
                out[f"{name}.{n}_proj_weight"] = ((E, kdim), ("uniform", math.sqrt(6 / (E + kdim))))
        out[f"{name}.in_proj_bias"] = ((3 * E,), ("const", 0.0))
        out[f"{name}.out_proj.weight"] = ((E, E), ("uniform", E ** -0.5))
        out[f"{name}.out_proj.bias"] = ((E,), ("const", 0.0))

    def cross(name, Da, Db):
        mha(f"{name}.a2b_attention", Da, Db)
        mha(f"{name}.b2a_attention", Da, Da)
        linear(f"{name}.a2b_ffn", Da, Da)
        linear(f"{name}.b2a_ffn", Da, Da)
        for j in range(4):
            ln(f"{name}.layernorms.{j}", Da)

    Dt, Dr, Do = cfg["bert_embed_dim"], cfg["resnet_embed_dim"], cfg["mention_final_output_dim"]
    fusion = "mention_encoder.intermediate_layer"
    cross(f"{fusion}.t2v_attention", Dt, Dr)
    cross(f"{fusion}.v2t_attention", Dr, Dt)
    linear(f"{fusion}.text_linear", Dt, Do)
    linear(f"{fusion}.image_linear", Dr, Do)
    linear(f"{fusion}.score_linear", 2 * Do, 2)
    linear("entity_final_layer", Dt, cfg["entity_final_output_dim"])
    return out


def _lin(p, name, x):
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def _attend(q, k, v, key_mask=None):
    """softmax(q·kᵀ / sqrt(d)) · v over [B, H, L, d]; ``key_mask`` [B, Lk]
    True where a key is dropped."""
    logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if key_mask is not None:
        logits = logits.masked_fill(key_mask[:, None, None, :], torch.finfo(logits.dtype).min)
    return torch.softmax(logits, dim=-1) @ v


def _heads(x, H):
    B, L, E = x.shape
    return x.reshape(B, L, H, E // H).transpose(1, 2)


def _merge(x):
    B, H, L, d = x.shape
    return x.transpose(1, 2).reshape(B, L, H * d)


def bert(p: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Last hidden states [N, L, D] of token ids [N, L] under mask [N, L]."""
    b = cfg["bert"]
    H, eps, L = b["num_attention_heads"], b["layer_norm_eps"], ids.shape[1]
    e = "bert.embeddings"
    x = (p[f"{e}.word_embeddings.weight"][ids] + p[f"{e}.position_embeddings.weight"][:L]
         + p[f"{e}.token_type_embeddings.weight"][0])
    ln = lambda name, t: F.layer_norm(t, t.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)
    x = ln(f"{e}.LayerNorm", x)
    dropped = mask == 0
    for i in range(b["num_hidden_layers"]):
        pre = f"bert.encoder.layer.{i}"
        q, k, v = (_heads(_lin(p, f"{pre}.attention.self.{n}", x), H)
                   for n in ("query", "key", "value"))
        a = _merge(_attend(q, k, v, dropped))
        x = ln(f"{pre}.attention.output.LayerNorm", x + _lin(p, f"{pre}.attention.output.dense", a))
        h = F.gelu(_lin(p, f"{pre}.intermediate.dense", x))
        x = ln(f"{pre}.output.LayerNorm", x + _lin(p, f"{pre}.output.dense", h))
    return x


def _mha(p, name, query, key, value, key_mask, H):
    if f"{name}.in_proj_weight" in p:
        qw, kw, vw = p[f"{name}.in_proj_weight"].chunk(3)
    else:
        qw, kw, vw = (p[f"{name}.{n}_proj_weight"] for n in ("q", "k", "v"))
    qb, kb, vb = p[f"{name}.in_proj_bias"].chunk(3)
    q, k, v = (_heads(x @ w.T + bias, H) for x, w, bias in
               ((query, qw, qb), (key, kw, kb), (value, vw, vb)))
    return _lin(p, f"{name}.out_proj", _merge(_attend(q, k, v, key_mask)))


def _cross(p, name, a, drop_a, b, drop_b, H):
    """a attends to b, the feed-forward; the result attends back to a."""
    ln = lambda j, t: F.layer_norm(t, t.shape[-1:], p[f"{name}.layernorms.{j}.weight"],
                                   p[f"{name}.layernorms.{j}.bias"], 1e-5)
    ab = ln(0, _mha(p, f"{name}.a2b_attention", a, b, b, drop_b, H))
    ab = ln(1, _lin(p, f"{name}.a2b_ffn", ab) + ab)
    aa = ln(2, _mha(p, f"{name}.b2a_attention", ab, a, a, drop_a, H))
    return ln(3, _lin(p, f"{name}.b2a_ffn", aa) + aa)


def fusion(p: dict, cfg: dict, text, text_mask, image) -> torch.Tensor:
    """The mention vector [B, D] from its token states and image regions."""
    H, f = cfg["transformer_num_heads"], "mention_encoder.intermediate_layer"
    drop = text_mask == 0
    t = _cross(p, f"{f}.t2v_attention", text, drop, image, None, H)
    at = F.gelu(_lin(p, f"{f}.text_linear", t.amax(1)))
    v = _cross(p, f"{f}.v2t_attention", image, None, text, drop, H)
    ai = F.gelu(_lin(p, f"{f}.image_linear", v.amax(1)))
    gate = torch.softmax(_lin(p, f"{f}.score_linear", torch.cat([at, ai], -1)), -1)
    return gate[:, :1] * at + gate[:, 1:] * ai


def unzip_mean(states: torch.Tensor, sep_idx: torch.Tensor) -> torch.Tensor:
    """Candidate vectors [B, S·E, D] from zipped sentence states [B, S, L,
    D]: candidate j of a sentence is the mean over positions from one past
    the previous [SEP] (position 1 for the first) up to its own [SEP]; a
    slot with no tokens gives 0."""
    B, S, L, D = states.shape
    hi = sep_idx.long()
    lo = torch.cat([torch.ones_like(hi[..., :1]), hi[..., :-1] + 1], -1)
    pos = torch.arange(L, device=states.device)
    m = ((pos >= lo[..., None]) & (pos < hi[..., None])).float()  # [B, S, E, L]
    out = (m[..., None] * states[:, :, None]).sum(-2) / m.sum(-1, keepdim=True).clamp(min=1.0)
    return out.reshape(B, -1, D)


def forward(p: dict, cfg: dict, batch: dict) -> torch.Tensor:
    """Scores [B, C] of an online request (the zipped fields by name)."""
    Lm = cfg["max_mention_sentence_len"]
    h = bert(p, cfg, batch["mention_ids"], batch["mention_mask"])
    mention = fusion(p, cfg, h[:, :Lm], batch["mention_mask"][:, :Lm],
                     batch["mention_image_feature"])
    ids = batch["entity_ids"]
    B, S, L = ids.shape
    C = cfg["num_candidates_data"] + 1
    states = torch.cat([bert(p, cfg, ids[i:i + 1].reshape(S, L),
                             batch["entity_mask"][i:i + 1].reshape(S, L))[None]
                        for i in range(B)])  # a mention's sentences at a time
    entity = _lin(p, "entity_final_layer", unzip_mean(states, batch["entity_sep_idx"])[:, :C])
    return cosine(mention[:, None], entity)
