"""Encoder self-attention: the CUDA kernel and its plain PyTorch version.

``fused_attention`` keeps the reference's signature and ``[B, S, D]``
layout.  On a CUDA tensor it launches ``csrc/attention.cu`` or
``csrc/attention_fp32.cu`` (the ports of
``infernos_tpu/ops/attention.py::_attn_kernel``) or raises; on a CPU tensor
it runs :func:`_plain_attention`, the math of the reference's
``_xla_attention``.  There is no fallback from the kernel to the plain path.

Two modes, as the Pallas kernel takes the dtype of q: bf16 q, k, v go to
``attn_fwd_bf16`` (``wgmma``, the full-width encoders), fp32 ones to
``attn_fwd_fp32`` (full fp32 FFMAs, the tiny and tiny-real encoders and the
trainers; a library of its own).  q, k and v of mixed dtypes raise; nothing
is cast to reach a kernel.  Each mode counts its own launches
(``fused_attention.launches`` and ``.launches_fp32``).

The fp32 mode runs at small shapes (``[4|8, 100|250, 64]`` a tiny-real
encode, ``[32, 250, 64]`` a trainer step), where q tiles of 64 rows leave
most of the card idle.  :func:`fp32_plan` picks, from the shape, the q rows
a block owns, the threads a row, and how many blocks of a thread-block
cluster split the key tiles (their partial softmax merged in distributed shared memory); the
wrapper hands the plan to the kernel as integers.

The kernel takes strides, so it reads each head's 64 columns out of the
``[B, S, D]`` projections and writes them into a ``[B, S, D]`` output: one
launch per call and no other work on the card.

Both modes are compute-bound at whisper-large-v3 width (see the source
notes in ``csrc/attention.cu`` and ``csrc/attention_fp32.cu``): 11.5 GFLOP
per call, 32 calls per encode.

Reverse mode, as the reference's ``custom_vjp`` has it: the forward is the
kernel and the backward recomputes the plain attention and differentiates
it (:class:`KernelAttention`).  ``fused_attention`` on the card takes that
route only when grad mode is on and an input requires grad, so serving
saves nothing and launches exactly as before.  A trainer's fp32
projections reach the fp32 mode, as the reference trains in fp32.
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
_ENTRIES = {torch.bfloat16: "attn_fwd_bf16", torch.float32: "attn_fwd_fp32"}
_LIBS = {torch.bfloat16: "attention", torch.float32: "attention_fp32"}

# the fp32 kernel's launch plan (csrc/attention_fp32.cu reads it)
FP32_KEYS = 64  # keys per staged tile
# (rows, X): a block owns `rows` q rows, X threads a row
FP32_SHAPES = ((64, 8), (32, 16), (16, 16))
FP32_SPLITS = (1, 2, 4, 8)  # blocks of a cluster sharing a q tile
FP32_TARGET_BLOCKS = 120  # about one block on each of an H100's 132 SMs
SMEM_MAX = 232448  # dynamic shared memory one block may ask for
_LD = HEAD_DIM + 4  # Q/K/partial-O rows (floats); P rows are HEAD_DIM + X
_STAGE_BYTES = (FP32_KEYS * _LD + FP32_KEYS * HEAD_DIM + FP32_KEYS) * 4  # K, V, mask row
_GRID_MAX = 2 ** 31 - 1


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
    ``HEAD_DIM``; rows and batches may lie anywhere 16-byte aligned.  q, k
    and v are all bf16 or all fp32."""
    B, S, D = q.shape
    if D != n_heads * HEAD_DIM:
        raise ValueError(f"attention kernel: head dim {D // max(n_heads, 1)} "
                         f"!= {HEAD_DIM} (width {D}, {n_heads} heads)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention kernel: q, k, v shapes differ")
    if q.dtype not in _ENTRIES:
        raise ValueError(f"attention kernel: q must be bf16 or fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel: q, k, v must share one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    per16 = 16 // q.element_size()  # values of one 16-byte copy
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        sb, sr, sc = t.stride()
        if sc != 1:
            raise ValueError(f"attention kernel: {name}'s last stride is "
                             f"{sc}, a head's row must be contiguous")
        if t.data_ptr() % 16 or (S > 1 and sr % per16) or (B > 1 and sb % per16):
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


def fp32_key_range(n_kt: int, split: int, rank: int):
    """Block ``rank`` of a cluster of ``split``: its key tiles ``[t0, t1)``
    of ``n_kt``, as the kernel computes them (none empty while split <= n_kt)."""
    return rank * n_kt // split, (rank + 1) * n_kt // split


def _fp32_candidates(n_kt: int) -> list:
    """Every (rows, X, split) the kernel takes for ``n_kt`` key
    tiles, in the order the plan tries them: splits of 1 and 2 before 4
    before 8 (a wider cluster merges dearer), larger q tiles first (fewer
    shared-memory reads per product)."""
    order = [(1, 2), (4,), (8,)]
    return [(r, x, c) for splits in order for r, x in FP32_SHAPES for c in splits
            if c <= n_kt]


def _fp32_choice(BH: int, S: int, n_kt: int) -> tuple:
    """The first candidate that launches at least FP32_TARGET_BLOCKS blocks,
    else the one with the most (of those the fewest rows)."""
    cands = _fp32_candidates(n_kt)
    blocks = [BH * -(-S // r) * c for r, _, c in cands]
    for cand, n in zip(cands, blocks):
        if n >= FP32_TARGET_BLOCKS:
            return cand
    return max(zip(cands, blocks), key=lambda cb: (cb[1], -cb[0][0]))[0]


@functools.lru_cache(maxsize=None)
def fp32_plan(BH: int, S: int, rows: Optional[int] = None, x: Optional[int] = None,
              split: Optional[int] = None) -> dict:
    """The fp32 kernel's launch plan for ``BH`` heads of ``S`` rows (cached:
    treat it as read-only).

    A block of 128 threads owns ``rows`` q rows of one head, ``x`` threads
    a row (:data:`FP32_SHAPES`); a cluster of ``split`` blocks
    shares one q tile, block r taking key tiles :func:`fp32_key_range` (64
    keys a tile).  Unless all three are given, the first of :func:`_fp32_candidates` that
    launches at least :data:`FP32_TARGET_BLOCKS` blocks is taken, else the
    one with the most blocks.  About one block an SM is the aim, not more:
    the kernel is bound by each SM's shared-memory reads, which blocks
    sharing an SM share, and every extra block or wider cluster adds loads
    and merging (``ops/attention_ablate.py --fp32`` times the others).
    Shared memory (byte offsets): Q ``rows x 68`` floats, P ``rows x (64 +
    x)``, ``stages`` (two where a block has two tiles or more, else one) of
    K ``64 x 68``, V ``64 x 64`` and a mask row, and, in a cluster, the
    partials pushed by its blocks, ``rows x 68`` (64 of O, m, l).  Raises
    ValueError for a shape it cannot hold: no rows or heads, a split past
    the key tiles, a grid of more than 2^31 - 1 blocks."""
    if BH < 1 or S < 1:
        raise ValueError(f"fp32 attention kernel: no plan for {BH} heads of {S} rows")
    n_kt = -(-S // FP32_KEYS)
    if rows is None or x is None or split is None:
        rows, x, split = _fp32_choice(BH, S, n_kt)
    if (rows, x) not in FP32_SHAPES or split not in FP32_SPLITS or split > n_kt:
        raise ValueError(f"fp32 attention kernel: no plan of {rows} rows ({x} threads a "
                         f"row) and {split} blocks a cluster for S {S} ({n_kt} key tiles)")
    n_qt = -(-S // rows)
    blocks = BH * n_qt * split
    if blocks > _GRID_MAX or S > _GRID_MAX - FP32_KEYS:
        raise ValueError(f"fp32 attention kernel: {BH} heads of {S} rows need "
                         f"{blocks} blocks, more than a grid holds")
    stages = min(2, -(-n_kt // split))
    sizes = {"q": rows * _LD * 4, "p": rows * (HEAD_DIM + x) * 4,
             "stage": stages * _STAGE_BYTES,
             "recv": rows * _LD * 4 if split > 1 else 0}
    offsets, at = {}, 0
    for name, n in sizes.items():
        offsets[name] = at
        at += n
    return {"BH": BH, "S": S, "rows": rows, "x": x, "split": split,
            "n_kt": n_kt, "n_qt": n_qt, "blocks": blocks, "stages": stages,
            "sizes": sizes, "offsets": offsets, "smem_bytes": at}


def fp32_plan_ints(plan: dict) -> list:
    """The plan as ``attn_fwd_fp32`` takes it."""
    o = plan["offsets"]
    return [plan[k] for k in ("rows", "x", "split", "stages")] + [
        o["p"], o["stage"], o["recv"], plan["smem_bytes"]]


_PlanInts = ctypes.c_int * 8


@functools.lru_cache(maxsize=None)
def _fp32_plan_arg(BH: int, S: int):
    return _PlanInts(*fp32_plan_ints(fp32_plan(BH, S)))


def entry_argtypes(dtype: torch.dtype) -> list:
    """The C entry's argument types: pointers q, k, v, mask, o, strides; B,
    H, S; scale; (fp32: the plan's ints;) stream."""
    plan = [ctypes.c_void_p] if dtype == torch.float32 else []
    return [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] + plan + [
        ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The C entry of ``dtype``'s mode, its library built at first use, with
    its argument types."""
    fn = getattr(build.load(_LIBS[dtype]), _ENTRIES[dtype])
    fn.argtypes = entry_argtypes(dtype)
    fn.restype = ctypes.c_int
    return fn


def _kernel_attention(q, k, v, mask_add=None, *, n_heads: int = 1):
    """Launch the CUDA kernel on heads where they lie.

    q, k, v ``[B, S, n_heads * 64]``, all bf16 or all fp32, any
    16-byte-aligned batch and row strides; mask_add ``[B, S]`` fp32
    additive (one row per batch element) or None.  Returns a contiguous
    ``[B, S, n_heads * 64]``.  With
    ``n_heads=1`` this is :func:`_plain_attention`'s ``[BH, S, Dh]``
    contract.  Raises on anything the kernel does not take (in fp32, a
    shape :func:`fp32_plan` cannot hold, before the device).  The output
    is in the inputs' dtype.
    """
    B, S, strides = _kernel_args(q, k, v, mask_add, n_heads)
    fp32 = q.dtype == torch.float32
    plan = (_fp32_plan_arg(B * n_heads, S),) if fp32 else ()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"attention kernel: {name} must be a CUDA "
                             f"tensor on one device, got {t.device}")
    fn = _entry(q.dtype)
    out = torch.empty((B, S, n_heads * HEAD_DIM), dtype=q.dtype,
                      device=q.device)
    strides += [out.stride(0), HEAD_DIM, out.stride(1)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_add is None else mask_add.data_ptr(),
            out.data_ptr(), _Strides(*strides), B, n_heads, S,
            float(HEAD_DIM ** -0.5), *plan, stream)
    build.check(rc, _ENTRIES[q.dtype])
    if fp32:
        fused_attention.launches_fp32 += 1
    else:
        fused_attention.launches += 1
    return out


class KernelAttention(torch.autograd.Function):
    """The kernel's forward with the reference's backward
    (``_pallas_attention_bwd``): the plain attention recomputed in fp32 from
    the saved inputs and differentiated; the mask gets no gradient, where
    the reference returns a zero cotangent.

    ``forward_fn`` is the forward (default :func:`_kernel_attention`); the
    CPU tests pass :func:`by_heads` over :func:`_plain_attention` to run
    the backward without a card."""

    @staticmethod
    def forward(ctx, q, k, v, mask_add, n_heads, forward_fn=None):
        fwd = forward_fn or _kernel_attention
        ctx.save_for_backward(q, k, v, mask_add)
        ctx.n_heads = n_heads
        return fwd(q, k, v, mask_add, n_heads=n_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask_add = ctx.saved_tensors
        with torch.enable_grad():
            qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
            out = by_heads(_plain_attention, qf, kf, vf, n_heads=ctx.n_heads,
                           mask_add=mask_add)
            dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), g.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def by_heads(core, q, k, v, *, n_heads: int,
             mask: Optional[torch.Tensor] = None,
             mask_add: Optional[torch.Tensor] = None):
    """Run ``core`` (``[BH, S, Dh]`` contract, as :func:`_plain_attention`)
    on ``[B, S, D]`` inputs: split heads, build the additive key mask (from
    ``mask``, or ``mask_add`` ``[B, S]`` as given), merge.  This is the CPU
    path's layout work; the kernel needs none of it."""
    B, S, D = q.shape
    Dh = D // n_heads

    def split(x):
        return (x.reshape(B, S, n_heads, Dh).transpose(1, 2)
                .reshape(B * n_heads, S, Dh).contiguous())

    if mask is not None:
        mask_add = _mask_add(mask)
    elif mask_add is None:
        mask_add = torch.zeros((B, S), dtype=torch.float32, device=q.device)
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
    a CPU tensor goes to the plain version.  On the card with grad mode on
    and an input that requires grad, the kernel runs inside
    :class:`KernelAttention`, which gives it the reference's backward.
    """
    if q.device.type == "cuda":
        mask_add = None if mask is None else _mask_add(mask)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return KernelAttention.apply(q, k, v, mask_add, n_heads)
        return _kernel_attention(q, k, v, mask_add, n_heads=n_heads)
    return by_heads(_plain_attention, q, k, v, n_heads=n_heads, mask=mask)


fused_attention.launches = 0  # bf16 kernel launches
fused_attention.launches_fp32 = 0  # fp32 kernel launches
