"""Encoder self-attention: the CUDA kernel and its plain PyTorch version.

``fused_attention`` keeps the reference's signature and ``[B, S, D]``
layout.  On a CUDA tensor it launches ``csrc/attention.cu`` (the port of
``infernos_tpu/ops/attention.py::_attn_kernel``) or raises; on a CPU tensor
it runs :func:`_plain_attention`, the math of the reference's
``_xla_attention``.  There is no fallback from the kernel to the plain path.

The kernel is compute-bound at whisper-large-v3 width (see the source note
in ``csrc/attention.cu``): 11.5 GFLOP per call, 32 calls per encode.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e9
HEAD_DIM = 64  # the kernel's compile-time head dim


def _plain_attention(q, k, v, mask_add):
    """q, k, v ``[BH, S, Dh]``; mask_add ``[BH, S]`` fp32 additive."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    logits = logits + mask_add[:, None, :]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", w, v)


def _kernel_attention(q, k, v, mask_add):
    """Launch the CUDA kernel; same contract as :func:`_plain_attention`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"attention kernel: {name} must be a bf16 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention kernel: {name} must be contiguous")
    BH, S, Dh = q.shape
    if Dh != HEAD_DIM:
        raise ValueError(f"attention kernel: head dim {Dh} != {HEAD_DIM}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention kernel: q, k, v shapes differ")
    if (mask_add.dtype != torch.float32 or mask_add.shape != (BH, S)
            or not mask_add.is_contiguous() or mask_add.device != q.device):
        raise ValueError("attention kernel: mask_add must be contiguous fp32 "
                         "[BH, S] on the same device")
    lib = build.load("attention")
    fn = lib.attn_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_add.data_ptr(),
            out.data_ptr(), BH, S, float(Dh ** -0.5), stream)
    build.check(rc, "attn_fwd_bf16")
    fused_attention.launches += 1
    return out


def by_heads(core, q, k, v, *, n_heads: int,
             mask: Optional[torch.Tensor] = None):
    """Run ``core`` (kernel or plain version, ``[BH, S, Dh]`` contract) on
    ``[B, S, D]`` inputs: split heads, build the additive key mask, merge."""
    B, S, D = q.shape
    Dh = D // n_heads

    def split(x):
        return (x.reshape(B, S, n_heads, Dh).transpose(1, 2)
                .reshape(B * n_heads, S, Dh).contiguous())

    if mask is None:
        mask_add = torch.zeros((B, S), dtype=torch.float32, device=q.device)
    else:
        mask_add = torch.where(mask.bool(), 0.0, NEG_INF).to(torch.float32)
    mask_bh = mask_add.repeat_interleave(n_heads, dim=0).contiguous()
    out = core(split(q), split(k), split(v), mask_bh)
    return out.reshape(B, n_heads, S, Dh).transpose(1, 2).reshape(B, S, D)


def fused_attention(q, k, v, *, n_heads: int,
                    mask: Optional[torch.Tensor] = None):
    """Multi-head self-attention on pre-projected tensors.

    q/k/v ``[B, S, D]`` (D = n_heads * head_dim); mask ``[B, S]`` bool
    (True = valid) or None.  Returns ``[B, S, D]``.  A CUDA tensor goes to
    the kernel (which raises on what it does not take), a CPU tensor to the
    plain version.
    """
    core = _kernel_attention if q.device.type == "cuda" else _plain_attention
    return by_heads(core, q, k, v, n_heads=n_heads, mask=mask)


fused_attention.launches = 0
