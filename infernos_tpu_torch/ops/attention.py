"""Encoder self-attention: the CUDA kernel and its plain PyTorch version.

``fused_attention`` keeps the reference's signature and ``[B, S, D]``
layout.  On a CUDA tensor it launches ``csrc/attention.cu`` (the port of
``infernos_tpu/ops/attention.py::_attn_kernel``) or raises; on a CPU tensor
it runs :func:`_plain_attention`, the math of the reference's
``_xla_attention``.  There is no fallback from the kernel to the plain path.

The kernel takes strides, so it reads each head's 64 columns out of the
``[B, S, D]`` projections and writes them into a ``[B, S, D]`` output: one
launch per call and no other work on the card.

The kernel is compute-bound at whisper-large-v3 width (see the source note
in ``csrc/attention.cu``): 11.5 GFLOP per call, 32 calls per encode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

NEG_INF = -1e9
HEAD_DIM = 64  # the kernel's compile-time head dim
_Strides = ctypes.c_longlong * 12  # (batch, head, row) of q, k, v and o


def _plain_attention(q, k, v, mask_add):
    """q, k, v ``[BH, S, Dh]``; mask_add ``[BH, S]`` fp32 additive."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    logits = logits + mask_add[:, None, :]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", w, v)


def _mask_add(mask):
    """Bool key mask (True = valid) -> additive fp32 mask."""
    return torch.where(mask.bool(), 0.0, NEG_INF).to(torch.float32)


def _kernel_args(q, k, v, mask_add, n_heads):
    """Check what the kernel needs of its inputs (all but the device) and
    return ``(B, S, strides)``: element strides (batch, head, row) of q, k, v
    in turn.  A head is a block of 64 contiguous columns, so its stride is
    ``HEAD_DIM``; rows and batches may lie anywhere 16-byte aligned."""
    B, S, D = q.shape
    if D != n_heads * HEAD_DIM:
        raise ValueError(f"attention kernel: head dim {D // max(n_heads, 1)} "
                         f"!= {HEAD_DIM} (width {D}, {n_heads} heads)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention kernel: q, k, v shapes differ")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"attention kernel: {name} must be bf16, "
                             f"got {t.dtype}")
        sb, sr, sc = t.stride()
        if sc != 1:
            raise ValueError(f"attention kernel: {name}'s last stride is "
                             f"{sc}, a head's row must be contiguous")
        # 16-byte copies: 8 bf16 values
        if t.data_ptr() % 16 or (S > 1 and sr % 8) or (B > 1 and sb % 8):
            raise ValueError(f"attention kernel: {name} is not 16-byte "
                             f"aligned (offset {t.data_ptr() % 16}, strides "
                             f"{t.stride()})")
        strides += [sb, HEAD_DIM, sr]
    if mask_add is not None and (
            mask_add.dtype != torch.float32 or mask_add.shape != (B, S)
            or not mask_add.is_contiguous() or mask_add.device != q.device):
        raise ValueError("attention kernel: mask_add must be contiguous fp32 "
                         "[B, S] on the same device")
    return B, S, strides


@functools.lru_cache(maxsize=None)
def _entry():
    """The library's C entry, built at first use, with its argument types."""
    fn = build.load("attention").attn_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel_attention(q, k, v, mask_add=None, *, n_heads: int = 1):
    """Launch the CUDA kernel on heads where they lie.

    q, k, v ``[B, S, n_heads * 64]`` bf16, any 16-byte-aligned batch and row
    strides; mask_add ``[B, S]`` fp32 additive (one row per batch element)
    or None.  Returns a contiguous ``[B, S, n_heads * 64]``.  With
    ``n_heads=1`` this is :func:`_plain_attention`'s ``[BH, S, Dh]``
    contract.  Raises on anything the kernel does not take.
    """
    B, S, strides = _kernel_args(q, k, v, mask_add, n_heads)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"attention kernel: {name} must be a CUDA "
                             f"tensor on one device, got {t.device}")
    fn = _entry()
    out = torch.empty((B, S, n_heads * HEAD_DIM), dtype=q.dtype,
                      device=q.device)
    strides += [out.stride(0), HEAD_DIM, out.stride(1)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_add is None else mask_add.data_ptr(),
            out.data_ptr(), _Strides(*strides), B, n_heads, S,
            float(HEAD_DIM ** -0.5), stream)
    build.check(rc, "attn_fwd_bf16")
    fused_attention.launches += 1
    return out


def by_heads(core, q, k, v, *, n_heads: int,
             mask: Optional[torch.Tensor] = None):
    """Run ``core`` (``[BH, S, Dh]`` contract, as :func:`_plain_attention`)
    on ``[B, S, D]`` inputs: split heads, build the additive key mask, merge.
    This is the CPU path's layout work; the kernel needs none of it."""
    B, S, D = q.shape
    Dh = D // n_heads

    def split(x):
        return (x.reshape(B, S, n_heads, Dh).transpose(1, 2)
                .reshape(B * n_heads, S, Dh).contiguous())

    if mask is None:
        mask_add = torch.zeros((B, S), dtype=torch.float32, device=q.device)
    else:
        mask_add = _mask_add(mask)
    mask_bh = mask_add.repeat_interleave(n_heads, dim=0).contiguous()
    out = core(split(q), split(k), split(v), mask_bh)
    return out.reshape(B, n_heads, S, Dh).transpose(1, 2).reshape(B, S, D)


def fused_attention(q, k, v, *, n_heads: int,
                    mask: Optional[torch.Tensor] = None):
    """Multi-head self-attention on pre-projected tensors.

    q/k/v ``[B, S, D]`` (D = n_heads * head_dim); mask ``[B, S]`` bool
    (True = valid) or None.  Returns ``[B, S, D]``.  A CUDA tensor goes to
    the kernel as it is -- no head split, no transposed copy, no mask tensor
    when ``mask`` is None -- and the kernel raises on what it does not take;
    a CPU tensor goes to the plain version.
    """
    if q.device.type == "cuda":
        return _kernel_attention(
            q, k, v, None if mask is None else _mask_add(mask),
            n_heads=n_heads)
    return by_heads(_plain_attention, q, k, v, n_heads=n_heads, mask=mask)


fused_attention.launches = 0
