"""Shared functional building blocks, in PyTorch.

Parameters are nested dicts of tensors with the reference's key paths and
leaf layouts: linear weights ``[in, out]``, conv weights
``[K, C_in/groups, C_out]``, transposed-conv weights ``[K, C_out, C_in]``.
Activations are ``[B, T, C]``.  Caches use the canonical
``[B, H, T, Dh]`` layout per layer; a single-query step writes its new K/V
row in place at each slot's position.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

NEG_INF = -1e9  # mask value; avoids -inf so all-masked rows stay NaN-free


# -- init helpers (seeded by an explicit torch.Generator) ---------------------

def _gen_device(generator: torch.Generator) -> torch.device:
    return torch.device(generator.device)


def uniform(generator, shape, bound, device, dtype=torch.float32):
    t = torch.empty(shape, device=_gen_device(generator), dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(device=device, dtype=dtype)


def normal(generator, shape, std, device, dtype=torch.float32):
    t = torch.empty(shape, device=_gen_device(generator), dtype=torch.float32)
    t.normal_(0.0, std, generator=generator)
    return t.to(device=device, dtype=dtype)


def linear_init(g, d_in, d_out, device, dtype, bias=True) -> Params:
    """torch.nn.Linear default init (kaiming-uniform fan_in), ``[in, out]``."""
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": uniform(g, (d_in, d_out), bound, device, dtype)}
    if bias:
        p["b"] = uniform(g, (d_out,), bound, device, dtype)
    return p


def embedding_init(g, n, d, device, dtype, padding_idx=None) -> Params:
    w = normal(g, (n, d), 1.0, device, dtype)
    if padding_idx is not None:
        w[padding_idx] = 0.0
    return {"w": w}


def layer_norm_init(d, device, dtype) -> Params:
    return {"g": torch.ones(d, device=device, dtype=dtype),
            "b": torch.zeros(d, device=device, dtype=dtype)}


def conv1d_init(g, c_in, c_out, k, device, dtype, bias=True) -> Params:
    bound = 1.0 / math.sqrt(c_in * k)
    p = {"w": uniform(g, (k, c_in, c_out), bound, device, dtype)}
    if bias:
        p["b"] = uniform(g, (c_out,), bound, device, dtype)
    return p


def stack_layers(layers):
    """List of per-layer dicts -> one dict with a leading layer dim."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)


def layer_slice(stacked, i: int):
    """Layer ``i`` of a stacked parameter dict."""
    if isinstance(stacked, dict):
        return {k: layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


# -- core ops -----------------------------------------------------------------

def linear(x, p: Params):
    if "w_q" in p:
        # int8 weight-only node (models/quant.py): the codes widen to the
        # activation type, the per-out-channel scale applies after the dot
        y = torch.matmul(x, p["w_q"].to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def gelu(x):
    return F.gelu(x, approximate="none")


def layer_norm(x, p: Params, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def conv1d(x, p: Params, *, stride=1, padding=0, dilation=1, groups=1):
    """x ``[B, T, C_in]`` -> ``[B, T', C_out]``; weight ``[K, C_in/groups, C_out]``."""
    w = p["w"].permute(2, 1, 0)  # -> torch [C_out, C_in/groups, K]
    y = F.conv1d(x.transpose(1, 2), w, p.get("b"), stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(x, p: Params, *, stride, padding):
    """x ``[B, T, C_in]`` -> ``[B, T*stride, C_out]`` (torch ConvTranspose1d
    semantics); weight ``[K, C_out, C_in]``."""
    w = p["w"].permute(2, 1, 0)  # -> torch [C_in, C_out, K]
    y = F.conv_transpose1d(x.transpose(1, 2), w, p.get("b"), stride=stride,
                           padding=padding)
    return y.transpose(1, 2)


def batch_norm_1d(x, p: Params, eps: float = 1e-5):
    """Inference-mode BatchNorm over the channel dim of ``[B, T, C]``."""
    inv = torch.rsqrt(p["running_var"] + eps)
    return (x - p["running_mean"]) * inv * p["g"] + p["b"]


# -- positions ----------------------------------------------------------------

def sinusoid_interleaved(max_len: int, dim: int) -> np.ndarray:
    """Interleaved sin/cos table (HF ScaledPositionalEncoding layout)."""
    pe = np.zeros((max_len, dim), np.float32)
    position = np.arange(max_len)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, dim, 2).astype(np.float64)
                 * -(math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


@lru_cache(maxsize=16)
def sinusoid_interleaved_table(max_len: int, dim: int, device: torch.device,
                               dtype: torch.dtype) -> torch.Tensor:
    """:func:`sinusoid_interleaved` as a tensor, built once per device/dtype
    (read-only: the same tensor is handed to every caller)."""
    return torch.from_numpy(sinusoid_interleaved(max_len, dim)).to(device, dtype)


def sinusoid_concat(num: int, dim: int, padding_idx: Optional[int] = None) -> np.ndarray:
    """Concatenated sin|cos table (fairseq/HF SinusoidalPositionalEmbedding)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    emb = np.exp(np.arange(half).astype(np.float64) * -emb)
    emb = np.arange(num).astype(np.float64)[:, None] * emb[None, :]
    out = np.concatenate([np.sin(emb), np.cos(emb)], axis=1).astype(np.float32)
    if dim % 2 == 1:
        out = np.concatenate([out, np.zeros((num, 1), np.float32)], axis=1)
    if padding_idx is not None:
        out[padding_idx] = 0.0
    return out


# -- attention ----------------------------------------------------------------

def split_heads(x, n_heads):
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads).transpose(1, 2)


def merge_heads(x):
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def attention(p: Params, x_q, x_kv=None, *, n_heads: int, mask=None,
              pos_bias=None, scale: Optional[float] = None):
    """Full (non-cached) multi-head attention.

    ``mask``: additive ``[B, 1, Tq, Tk]`` or None.  ``pos_bias``:
    SpeechT5-style relative key embeddings ``[Tq, Tk, Dh]``.
    """
    if x_kv is None:
        x_kv = x_q
    D = x_q.shape[-1]
    dh = D // n_heads
    scale = scale if scale is not None else dh ** -0.5
    q = split_heads(linear(x_q, p["q"]), n_heads) * scale
    k = split_heads(linear(x_kv, p["k"]), n_heads)
    v = split_heads(linear(x_kv, p["v"]), n_heads)
    logits = torch.matmul(q, k.transpose(-1, -2))
    if pos_bias is not None:
        logits = logits + torch.einsum("bhqd,qkd->bhqk", q, pos_bias)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v)
    return linear(merge_heads(out), p["o"])


def write_rows(cache, new, pos, write=None):
    """In place: ``cache[b, :, pos[b]] = new[b]`` for every slot ``b``.

    cache ``[B, H, T, Dh]``, new ``[B, H, Dh]``, pos ``[B]``.  Positions
    past the end land on the last row (the reference's clamped
    ``dynamic_update_slice``).  ``write`` ``[B]`` bool keeps the old row
    where False, without a host sync.
    """
    B, _, T, _ = cache.shape
    b = torch.arange(B, device=cache.device)
    wp = pos.long().clamp(max=T - 1)
    new = new.to(cache.dtype)
    if write is not None:
        new = torch.where(write[:, None, None], new, cache[b, :, wp])
    cache[b, :, wp] = new
    return wp


def attention_step(p: Params, x_q, *, n_heads: int, k_cache, v_cache, pos,
                   write=None):
    """Single-query cached self-attention step for slot-batched AR decode.

    x_q ``[B, 1, D]``; caches ``[B, H, Tmax, Dh]`` (updated in place at each
    slot's ``pos``); pos ``[B]``.  Returns ``[B, 1, D]``.
    """
    D = x_q.shape[-1]
    dh = D // n_heads
    q = split_heads(linear(x_q, p["q"]), n_heads) * dh ** -0.5  # [B,H,1,dh]
    k_new = split_heads(linear(x_q, p["k"]), n_heads)[:, :, 0]
    v_new = split_heads(linear(x_q, p["v"]), n_heads)[:, :, 0]
    wp = write_rows(k_cache, k_new, pos, write)
    write_rows(v_cache, v_new, pos, write)
    T = k_cache.shape[2]
    valid = torch.arange(T, device=x_q.device)[None, :] <= wp[:, None]  # [B,T]
    logits = torch.matmul(q, k_cache.to(q.dtype).transpose(-1, -2))
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v_cache.to(q.dtype))
    return linear(merge_heads(out), p["o"])


def cross_attention_step(p: Params, x_q, k_cache, v_cache, *, n_heads: int,
                         kv_mask=None):
    """Single-query cross-attention against precomputed encoder K/V
    ``[B, H, S, Dh]``; kv_mask ``[B, S]`` bool (True = valid)."""
    D = x_q.shape[-1]
    dh = D // n_heads
    q = split_heads(linear(x_q, p["q"]), n_heads) * dh ** -0.5
    logits = torch.matmul(q, k_cache.to(q.dtype).transpose(-1, -2))
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v_cache.to(q.dtype))
    return linear(merge_heads(out), p["o"])


def precompute_cross_kv(p: Params, enc_out, *, n_heads: int):
    """Encoder K/V ``[B, H, S, Dh]`` for cross-attention (once per join)."""
    k = split_heads(linear(enc_out, p["k"]), n_heads)
    v = split_heads(linear(enc_out, p["v"]), n_heads)
    return k, v


# -- masks --------------------------------------------------------------------

def pad_mask_to_bias(mask_b_s, tq: int):
    """``[B, S]`` 0/1 -> additive ``[B, 1, tq, S]``."""
    bias = torch.where(mask_b_s.bool(), 0.0, NEG_INF).to(torch.float32)
    return bias[:, None, None, :].expand(-1, 1, tq, -1)


def causal_bias(T: int, device=None):
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return torch.where(j <= i, 0.0, NEG_INF).to(torch.float32)[None, None]
