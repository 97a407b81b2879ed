"""Whisper-class speech-to-text model in PyTorch.

Architecture and numerics follow the reference (``infernos_tpu/models/
whisper.py``, itself HF ``WhisperForConditionalGeneration``); parameters
share its key paths and leaf layouts.  The encoder's self-attention runs
through :func:`infernos_tpu_torch.ops.attention.fused_attention` (the CUDA
kernel on the card).  Caches keep the canonical ``[L, B, H, T, Dh]`` layout
and each decode step writes its K/V row in place at the slot's position.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import layers as L
from ..ops.attention import fused_attention


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51866
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    decoder_layers: int = 32
    decoder_attention_heads: int = 20
    ffn_dim: int = 5120
    max_source_positions: int = 1500
    max_target_positions: int = 448
    eos_token_id: int = 50257
    sot_token_id: int = 50258
    no_speech_token_id: int = 50363

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper fixed encoder positional table (OpenAI layout: sin|cos)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# -- init ---------------------------------------------------------------------

def _attn_init(g, d, dev, dt):
    return {"q": L.linear_init(g, d, d, dev, dt),
            "k": L.linear_init(g, d, d, dev, dt, bias=False),
            "v": L.linear_init(g, d, d, dev, dt),
            "o": L.linear_init(g, d, d, dev, dt)}


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                device, dtype=torch.float32) -> Dict[str, Any]:
    """Seeded random parameters (torch.nn default inits) on ``device``."""
    d = cfg.d_model
    g = generator

    def enc_layer():
        return {"ln1": L.layer_norm_init(d, device, dtype),
                "attn": _attn_init(g, d, device, dtype),
                "ln2": L.layer_norm_init(d, device, dtype),
                "fc1": L.linear_init(g, d, cfg.ffn_dim, device, dtype),
                "fc2": L.linear_init(g, cfg.ffn_dim, d, device, dtype)}

    def dec_layer():
        return {"ln1": L.layer_norm_init(d, device, dtype),
                "self_attn": _attn_init(g, d, device, dtype),
                "ln2": L.layer_norm_init(d, device, dtype),
                "cross_attn": _attn_init(g, d, device, dtype),
                "ln3": L.layer_norm_init(d, device, dtype),
                "fc1": L.linear_init(g, d, cfg.ffn_dim, device, dtype),
                "fc2": L.linear_init(g, cfg.ffn_dim, d, device, dtype)}

    return {
        "conv1": L.conv1d_init(g, cfg.num_mel_bins, d, 3, device, dtype),
        "conv2": L.conv1d_init(g, d, d, 3, device, dtype),
        "enc_pos": torch.from_numpy(
            _sinusoids(cfg.max_source_positions, d)).to(device, dtype),
        "enc_layers": L.stack_layers(
            [enc_layer() for _ in range(cfg.encoder_layers)]),
        "enc_ln": L.layer_norm_init(d, device, dtype),
        "tok_embed": L.embedding_init(g, cfg.vocab_size, d, device, dtype),
        "dec_pos": {"w": L.normal(g, (cfg.max_target_positions, d), 0.02,
                                  device, dtype)},
        "dec_layers": L.stack_layers(
            [dec_layer() for _ in range(cfg.decoder_layers)]),
        "dec_ln": L.layer_norm_init(d, device, dtype),
    }


# -- encoder ------------------------------------------------------------------

def encode(params, cfg: WhisperConfig, mel):
    """mel ``[B, n_mels, T]`` -> encoder states ``[B, T//2, D]``."""
    x = mel.transpose(1, 2)
    x = L.gelu(L.conv1d(x, params["conv1"], padding=1))
    x = L.gelu(L.conv1d(x, params["conv2"], stride=2, padding=1))
    S = x.shape[1]
    if S > params["enc_pos"].shape[0]:
        raise ValueError(f"audio too long: {S} frames > max_source_positions "
                         f"{params['enc_pos'].shape[0]}")
    x = x + params["enc_pos"][:S].to(x.dtype)
    H = cfg.encoder_attention_heads
    for i in range(cfg.encoder_layers):
        lp = L.layer_slice(params["enc_layers"], i)
        h_in = L.layer_norm(x, lp["ln1"])
        q = L.linear(h_in, lp["attn"]["q"])
        k = L.linear(h_in, lp["attn"]["k"])
        v = L.linear(h_in, lp["attn"]["v"])
        h = fused_attention(q, k, v, n_heads=H)
        x = x + L.linear(h, lp["attn"]["o"])
        h = L.layer_norm(x, lp["ln2"])
        x = x + L.linear(L.gelu(L.linear(h, lp["fc1"])), lp["fc2"])
    return L.layer_norm(x, params["enc_ln"])


# -- decoder ------------------------------------------------------------------

@dataclasses.dataclass
class WhisperCache:
    self_k: torch.Tensor  # [L, B, H, Tmax, Dh]
    self_v: torch.Tensor
    # dense [L, B, H, S, Dh], or int8 dicts {"q": int8, "s": f32 [..., S, 1]}
    cross_k: Any
    cross_v: Any


def quantize_kv(x) -> Dict[str, torch.Tensor]:
    """Per-position symmetric int8 over the head dim: ``[..., S, Dh]`` ->
    ``{"q": int8 [..., S, Dh], "s": f32 [..., S, 1]}`` (the cross K/V cache
    is the decode step's dominant memory traffic; int8 halves it vs bf16)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    s = amax / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_kv(c, dtype):
    """Inverse of :func:`quantize_kv`; dense tensors pass through."""
    if isinstance(c, dict):
        return c["q"].to(dtype) * c["s"].to(dtype)
    return c


def init_cache(cfg: WhisperConfig, batch: int, max_steps: int, enc_len: int,
               device, dtype=torch.float32,
               cross_int8: bool = False) -> WhisperCache:
    Lyr, H, Dh = cfg.decoder_layers, cfg.decoder_attention_heads, cfg.head_dim

    def z(t):
        return torch.zeros((Lyr, batch, H, t, Dh), dtype=dtype, device=device)

    def zq(t):
        return {"q": torch.zeros((Lyr, batch, H, t, Dh), dtype=torch.int8,
                                 device=device),
                "s": torch.zeros((Lyr, batch, H, t, 1), dtype=torch.float32,
                                 device=device)}

    if cross_int8:
        return WhisperCache(z(max_steps), z(max_steps), zq(enc_len), zq(enc_len))
    return WhisperCache(z(max_steps), z(max_steps), z(enc_len), z(enc_len))


def cross_kv(params, cfg: WhisperConfig, enc_out):
    """Per-layer cross K/V of ``enc_out``: two ``[L, B, H, S, Dh]`` tensors."""
    ks, vs = [], []
    for i in range(cfg.decoder_layers):
        lp = L.layer_slice(params["dec_layers"], i)
        k, v = L.precompute_cross_kv(lp["cross_attn"], enc_out,
                                     n_heads=cfg.decoder_attention_heads)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def fill_cross_kv(params, cfg: WhisperConfig, cache: WhisperCache,
                  enc_out) -> WhisperCache:
    ks, vs = cross_kv(params, cfg, enc_out)
    if isinstance(cache.cross_k, dict):
        ks, vs = quantize_kv(ks), quantize_kv(vs)
    return dataclasses.replace(cache, cross_k=ks, cross_v=vs)


def _layer_kv(c, i):
    if isinstance(c, dict):
        return {k: v[i] for k, v in c.items()}
    return c[i]


def decode_step(params, cfg: WhisperConfig, tokens, cache: WhisperCache, pos,
                enc_mask=None, write: Optional[torch.Tensor] = None):
    """One greedy step for all slots: tokens ``[B]``, pos ``[B]`` -> logits
    ``[B, V]``.  The self caches are updated in place at ``pos`` (only for
    slots where ``write`` is True, when given)."""
    H = cfg.decoder_attention_heads
    n_pos = params["dec_pos"]["w"].shape[0]
    x = (params["tok_embed"]["w"][tokens.long()]
         + params["dec_pos"]["w"][pos.long().clamp(max=n_pos - 1)])[:, None, :]
    for i in range(cfg.decoder_layers):
        lp = L.layer_slice(params["dec_layers"], i)
        x = x + L.attention_step(lp["self_attn"], L.layer_norm(x, lp["ln1"]),
                                 n_heads=H, k_cache=cache.self_k[i],
                                 v_cache=cache.self_v[i], pos=pos, write=write)
        x = x + L.cross_attention_step(
            lp["cross_attn"], L.layer_norm(x, lp["ln2"]),
            dequantize_kv(_layer_kv(cache.cross_k, i), x.dtype),
            dequantize_kv(_layer_kv(cache.cross_v, i), x.dtype),
            n_heads=H, kv_mask=enc_mask)
        h = L.layer_norm(x, lp["ln3"])
        x = x + L.linear(L.gelu(L.linear(h, lp["fc1"])), lp["fc2"])
    x = L.layer_norm(x, params["dec_ln"])[:, 0]
    return x @ params["tok_embed"]["w"].T
