"""Plain PyTorch reference of granite-4.0-h-micro's decoder stack
(``granitemoehybrid``, huggingface.co/ibm-granite/granite-4.0-h-micro
config.json; Mamba-2: Dao and Gu, arXiv 2405.21060), as a text tower: the
last hidden states after the final norm.

Float32 with TF32 off (the caller's ``precision``), no kernels, no cache,
nothing chunked.  It imports nothing of the program: the weights are a dict
under the upstream keys (:func:`param_shapes`), ``model.`` first.

* ``x = embed(ids) * embedding_multiplier``; per layer ``x += r *
  mixer(rmsnorm(x))`` and ``x += r * output_linear(silu(a) * b)`` with
  ``[a, b] = input_linear(rmsnorm(x))``, ``r = residual_multiplier``; the
  mixer is Mamba-2 or attention by ``layer_types``; a last RMSNorm.  Every
  RMSNorm has a weight and eps ``rms_norm_eps``.
* Attention: q, k, v without bias, the key heads repeated to the query
  heads (head ``j * G + g`` reads key head ``j``), causal,
  ``softmax(q.k^T * attention_multiplier)``, ``o_proj``; no positions.
* Mamba-2: ``in_proj`` -> ``[z, xBC, dt]``; ``xBC`` through the causal
  depthwise conv of width ``mamba_d_conv`` (written out as shifted sums,
  with its bias) and silu -> ``x, B, C``; ``dt = softplus(dt + dt_bias)``,
  ``A = -exp(A_log)``; the scan in its quadratic form over the whole
  sequence, ``y = (M o C.B^T) . (dt * x) + D * x`` with ``M[t, s] =
  exp(sum_{s < r <= t} dt_r * A)`` for ``s <= t`` (Mamba-2's ``segsum``,
  exact and independent of any chunking), in blocks of sequences and heads;
  ``rmsnorm(y * silu(z))`` over all channels (one group); ``out_proj``.

``control=True`` is the control a precision below the configuration's
bf16: every linear of the tower takes its input and its weight rounded to
float8 e4m3 under a per-tensor scale.

Departures from the published model: random seeded weights (:func:`init_ssm`
says how the state-space parameters are drawn); no LM head
(``logits_scaling`` is not used).
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

BLOCK_ELEMS = 1 << 27  # the most [L, L] weights of the scan or logits of attention held at once


def param_shapes(cfg: dict, prefix: str = "model.") -> dict:
    """name -> (shape, init) as the benchmark's ``make_weights`` takes them:
    linears and the embedding N(0, 0.02), norms 1, ``D`` 1, the conv torch's
    default (uniform over +-1/sqrt(width)); ``A_log`` and ``dt_bias`` a
    uniform draw over +-1 that :func:`init_ssm` maps to their laws."""
    D, V, F_ = cfg["hidden_size"], cfg["vocab_size"], cfg["shared_intermediate_size"]
    H, P, S, K = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], \
        cfg["mamba_d_conv"]
    Hq, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // Hq
    d_inner = H * P
    conv = d_inner + 2 * S
    normal, one = ("normal", 0.02), ("const", 1.0)
    out = {f"{prefix}embed_tokens.weight": ((V, D), normal)}
    for i, kind in enumerate(cfg["layer_types"]):
        pre = f"{prefix}layers.{i}."
        out[pre + "input_layernorm.weight"] = ((D,), one)
        if kind == "mamba":
            m = pre + "mamba."
            out[m + "in_proj.weight"] = ((d_inner + conv + H, D), normal)
            out[m + "conv1d.weight"] = ((conv, 1, K), ("uniform", K ** -0.5))
            out[m + "conv1d.bias"] = ((conv,), ("uniform", K ** -0.5))
            out[m + "dt_bias"] = ((H,), ("uniform", 1.0))
            out[m + "A_log"] = ((H,), ("uniform", 1.0))
            out[m + "D"] = ((H,), one)
            out[m + "norm.weight"] = ((d_inner,), one)
            out[m + "out_proj.weight"] = ((D, d_inner), normal)
        else:
            a = pre + "self_attn."
            out[a + "q_proj.weight"] = ((Hq * hd, D), normal)
            out[a + "k_proj.weight"] = ((Hk * hd, D), normal)
            out[a + "v_proj.weight"] = ((Hk * hd, D), normal)
            out[a + "o_proj.weight"] = ((D, Hq * hd), normal)
        out[pre + "post_attention_layernorm.weight"] = ((D,), one)
        out[pre + "shared_mlp.input_linear.weight"] = ((2 * F_, D), normal)
        out[pre + "shared_mlp.output_linear.weight"] = ((D, F_), normal)
    out[f"{prefix}norm.weight"] = ((D,), one)
    return out


@torch.no_grad()
def init_ssm(p: dict, cfg: dict, prefix: str = "model.") -> None:
    """Map the uniform draws u in [-1, 1) of each Mamba-2 layer, in place, to
    Mamba-2's initialisation: ``A_log = log U(1, 16)``; ``dt`` log-uniform in
    [1e-3, 1e-1] and ``dt_bias`` its inverse softplus."""
    for i, kind in enumerate(cfg["layer_types"]):
        if kind != "mamba":
            continue
        m = f"{prefix}layers.{i}.mamba."
        u = (p[m + "A_log"] + 1) / 2
        p[m + "A_log"].copy_(torch.log(1 + 15 * u))
        u = (p[m + "dt_bias"] + 1) / 2
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        p[m + "dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude at e4m3's largest, 448), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def rmsnorm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: ``out[t, s] = sum_{s < r <= t} a_r`` for
    ``s <= t``, -inf above the diagonal."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)  # x[..., r, s] = a_r
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    seg = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    return seg.masked_fill(~torch.ones_like(below).tril(), float("-inf"))


def ssd_quadratic(x, dt, A, B, C, D):
    """x [N, L, H, P], dt [N, L, H], A [H], B and C [N, L, S], D [H] -> y [N,
    L, H, P]: the scan as one product over the whole sequence, in blocks of
    sequences and heads of at most BLOCK_ELEMS decay weights."""
    N, L, H, P = x.shape
    scores = C @ B.transpose(1, 2)  # [N, L, L]
    y = torch.empty_like(x)
    heads = max(1, min(H, BLOCK_ELEMS // (L * L)))
    seqs = max(1, BLOCK_ELEMS // (heads * L * L))
    for n0 in range(0, N, seqs):
        ns = slice(n0, n0 + seqs)
        for h0 in range(0, H, heads):
            hs = slice(h0, h0 + heads)
            M = torch.exp(segsum((dt[ns, :, hs] * A[hs]).transpose(1, 2)))  # [n, h, L, L]
            u = (dt[ns, :, hs, None] * x[ns, :, hs]).transpose(1, 2)  # [n, h, L, P]
            y[ns, :, hs] = ((M * scores[ns, None]) @ u).transpose(1, 2) + D[hs, None] * x[ns, :, hs]
    return y


def _mamba(p, m, cfg, h, lin):
    N, L, _ = h.shape
    H, P, S, K = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], \
        cfg["mamba_d_conv"]
    d_inner = H * P
    z, xBC, dt = lin(h, m + "in_proj.weight").split([d_inner, d_inner + 2 * S, H], dim=-1)
    w, b = p[m + "conv1d.weight"][:, 0], p[m + "conv1d.bias"]  # [conv, K]
    padded = F.pad(xBC, (0, 0, K - 1, 0))
    xBC = F.silu(sum(w[:, j] * padded[:, j:j + L] for j in range(K)) + b)
    xs, B, C = xBC.split([d_inner, S, S], dim=-1)
    dt = F.softplus(dt + p[m + "dt_bias"])
    A = -torch.exp(p[m + "A_log"])
    y = ssd_quadratic(xs.reshape(N, L, H, P), dt, A, B, C, p[m + "D"]).reshape(N, L, d_inner)
    y = rmsnorm(y * F.silu(z), p[m + "norm.weight"], cfg["rms_norm_eps"])
    return lin(y, m + "out_proj.weight")


def _attention(a, cfg, h, lin):
    N, L, D = h.shape
    Hq, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // Hq
    q = lin(h, a + "q_proj.weight").view(N, L, Hq, hd).transpose(1, 2)
    k = lin(h, a + "k_proj.weight").view(N, L, Hk, hd).transpose(1, 2)
    v = lin(h, a + "v_proj.weight").view(N, L, Hk, hd).transpose(1, 2)
    k, v = k.repeat_interleave(Hq // Hk, dim=1), v.repeat_interleave(Hq // Hk, dim=1)
    future = torch.ones(L, L, dtype=torch.bool, device=h.device).triu(1)
    out = []
    step = max(1, BLOCK_ELEMS // (Hq * L * L))
    for n in range(0, N, step):  # [n, Hq, L, L] logits at a time
        logits = (q[n:n + step] @ k[n:n + step].transpose(-1, -2)) * cfg["attention_multiplier"]
        out.append(torch.softmax(logits.masked_fill(future, float("-inf")), -1) @ v[n:n + step])
    return lin(torch.cat(out).transpose(1, 2).reshape(N, L, D), a + "o_proj.weight")


def tower(p: dict, cfg: dict, ids: torch.Tensor, control: bool = False,
          prefix: str = "model.") -> torch.Tensor:
    """Last hidden states [N, L, D] of token ids [N, L] (right-padded: the
    stack is causal, so padding after a token never reaches it)."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]

    def lin(x, name):
        w = p[name]
        return fp8(x) @ fp8(w).T if control else x @ w.T

    x = p[prefix + "embed_tokens.weight"][ids] * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"]):
        pre = f"{prefix}layers.{i}."
        h = rmsnorm(x, p[pre + "input_layernorm.weight"], eps)
        if kind == "mamba":
            h = _mamba(p, pre + "mamba.", cfg, h, lin)
        else:
            h = _attention(pre + "self_attn.", cfg, h, lin)
        x = x + h * r
        h = rmsnorm(x, p[pre + "post_attention_layernorm.weight"], eps)
        a, b = lin(h, pre + "shared_mlp.input_linear.weight").chunk(2, dim=-1)
        x = x + lin(F.silu(a) * b, pre + "shared_mlp.output_linear.weight") * r
    return rmsnorm(x, p[prefix + "norm.weight"], eps)
