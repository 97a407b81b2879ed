"""Int8-direct cross-attention core: the CUDA kernel and its plain version.

The port of the reference's XLA path ``infernos_tpu/models/layers.py::
cross_attention_step_i8`` between its two projections (the reference has
no Pallas kernel for it).  The decode step reads the int8 cross cache as it
is stored, never dequantized:

- q is quantized per (b, h) to int8 codes ``qq`` with one scale ``qs``;
  the logits are ``(qq . kq) * qs * ks[s]``, the product s8 x s8 -> s32;
- masked positions get ``NEG_INF`` and the softmax is fp32;
- V's per-position scales fold into the probabilities (``wp = w * vs``),
  which are quantized per (b, h) to codes ``wq`` in [0, 127] with one
  scale ``ws``; the output is ``(wq . vq) * ws``, again s8 x s8 -> s32.

Against the dequantize path, only the int8 rounding of q and of ``wp``
is new (about 0.4% of a row's max).

:func:`cross_attention_i8` takes q ``[B, H, 1, Dh]`` (already scaled by
``Dh ** -0.5``, bf16 or fp32), the canonical int8 cache entries of one
layer, ``{"q": int8 [B, H, S, Dh], "s": f32 [B, H, S, 1]}``
(``models/whisper.py`` ``quantize_kv``), and a ``[B, S]`` bool mask (True
= valid) or None.  It returns ``[B, H, 1, Dh]`` in q's dtype.  On CUDA
tensors it launches ``csrc/cross_attention_i8.cu`` under the plan of
:func:`cross_i8_plan` or raises; on CPU tensors it runs
:func:`_plain_cross_attention_i8`.  There is no fallback.  Each launch adds
one to ``cross_attention_i8.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

NEG_INF = -1e9
HEAD_DIM = 64  # the kernel's compile-time head dim
SMEM_MAX = 232448  # shared memory one block may ask for
STATIC_SMEM = 4096  # the kernel's static arrays, at most
SM_SMEM = 233472  # shared memory of one SM (228 KB)
BLOCK_RESERVED = 1024  # shared memory the card keeps per resident block
SMS = 132  # H100 SXM
RESIDENT_THREADS = 1280  # the kernel's __launch_bounds__: threads an SM
CLUSTERS = (1, 2, 4, 8)
THREADS = (64, 128, 256)
TARGET_BLOCKS = 4 * SMS  # the blocks a plan aims for: at least 4 an SM
# int32 products stay exact while 127 * 127 * S < 2^31; a block holds a K
# slot of `threads` rows of 64 bytes and 16 bytes of each of its positions
# (logit, two scales, list)
MAX_S = min((2 ** 31 - 1) // (127 * 127),
            max(CLUSTERS) * ((SMEM_MAX - STATIC_SMEM - HEAD_DIM * min(THREADS)) // 16))
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _widened_dot(a, b, dim: int = -1):
    """``sum(a * b)`` over ``dim`` (broadcasting), both widened to int32
    first: int8 products wrap (torch's int8 matmul returns int8), and an
    integer matmul has no CUDA implementation, so the products are
    elementwise."""
    return (a.to(torch.int32) * b.to(torch.int32)).sum(dim, dtype=torch.int32)


def _plain_cross_attention_i8(q, k_c, v_c, kv_mask=None, return_codes=False):
    """The reference's arithmetic, line by line, in PyTorch.  Every
    quotient is an IEEE division, as the kernel's: the scales divide by a
    tensor of 127s, since PyTorch on the card turns a division by a Python
    number into a product with its reciprocal, which moves codes at ties.

    q ``[B, H, 1, Dh]``; ``k_c``/``v_c`` ``{"q": int8 [B, H, S, Dh], "s":
    f32 [B, H, S, 1]}``; kv_mask ``[B, S]`` bool or None.  Returns ``[B,
    H, 1, Dh]`` in q's dtype, and with ``return_codes`` also q's codes
    ``[B, H, Dh]`` and the weights' codes ``[B, H, S]`` (int8)."""
    qf = q.float()
    qa = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    qs = qa / torch.full_like(qa, 127.0)
    qq = torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8)  # [B,H,1,Dh]
    acc = _widened_dot(qq, k_c["q"])  # [B, H, S]
    logits = acc.float()[:, :, None, :] * qs * k_c["s"].transpose(-1, -2)
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)  # the reference's softmax: exp(x - max) / sum
    wp = w * v_c["s"].transpose(-1, -2)  # fold per-position V scales into the probs
    wa = wp.amax(dim=-1, keepdim=True).clamp_min(1e-20)
    ws = wa / torch.full_like(wa, 127.0)
    wq = torch.clamp(torch.round(wp / ws), 0, 127).to(torch.int8)  # [B,H,1,S]
    acc2 = _widened_dot(wq.transpose(-1, -2), v_c["q"], dim=-2)  # [B, H, Dh]
    out = (acc2.float()[:, :, None, :] * ws).to(q.dtype)
    if return_codes:
        return out, qq[:, :, 0], wq[:, :, 0]
    return out


def _check_args(q, k_c, v_c, kv_mask):
    """What the kernel takes, checked before the device; returns (B, H, S)."""
    if q.dim() != 4 or q.shape[2] != 1 or q.shape[3] != HEAD_DIM:
        raise ValueError(f"cross_attention_i8 kernel: q must be [B, H, 1, "
                         f"{HEAD_DIM}], got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"cross_attention_i8 kernel: q must be bf16 or fp32, "
                         f"got {q.dtype}")
    B, H = q.shape[:2]
    S = k_c["q"].shape[2]
    for name, c in (("k", k_c), ("v", v_c)):
        codes, scales = c["q"], c["s"]
        if codes.dtype != torch.int8 or scales.dtype != torch.float32:
            raise ValueError(f"cross_attention_i8 kernel: {name} cache must be "
                             f"int8 codes and fp32 scales, got {codes.dtype}, "
                             f"{scales.dtype}")
        if codes.shape != (B, H, S, HEAD_DIM) or scales.shape != (B, H, S, 1):
            raise ValueError(f"cross_attention_i8 kernel: {name} cache shapes "
                             f"{tuple(codes.shape)}, {tuple(scales.shape)}, want "
                             f"{(B, H, S, HEAD_DIM)} and {(B, H, S, 1)}")
        if not (codes.is_contiguous() and scales.is_contiguous()) or codes.data_ptr() % 16:
            raise ValueError(f"cross_attention_i8 kernel: {name} cache must be "
                             f"contiguous, its codes 16-byte aligned")
    if not q.is_contiguous():
        raise ValueError("cross_attention_i8 kernel: q must be contiguous")
    if kv_mask is not None and (kv_mask.dtype != torch.bool or kv_mask.shape != (B, S)
                                or not kv_mask.is_contiguous()):
        raise ValueError(f"cross_attention_i8 kernel: kv_mask must be a contiguous "
                         f"bool [B, S] = {(B, S)}")
    return B, H, S


def block_range(S: int, cluster: int, rank: int) -> tuple:
    """Block ``rank`` of a cluster of ``cluster``: its positions ``[s0, s1)``
    of S, as the kernel computes them (empty where S < cluster)."""
    R = -(-S // cluster)
    s0 = min(S, rank * R)
    return s0, min(S, s0 + R)


def _blocks_per_sm(blocks: int, threads: int, smem_bytes: int) -> int:
    """Blocks of one SM when ``blocks`` spread evenly over the card, or the
    most one SM holds (threads, shared memory), whichever is fewer."""
    hold = min(RESIDENT_THREADS // threads,
               SM_SMEM // (smem_bytes + STATIC_SMEM + BLOCK_RESERVED))
    return min(-(-blocks // SMS), hold)


def _smem(threads: int, R: int) -> int:
    """Dynamic shared-memory bytes of a block: its K slot, then four arrays
    of ``R`` (rounded up to 4) words."""
    return threads * HEAD_DIM + 16 * (-(-R // 4) * 4)


def _resident_threads(blocks: int) -> tuple:
    """The thread counts a block, most first, that keep every block of a
    grid of ``blocks`` resident at once (the smallest where none does)."""
    wave = -(-blocks // SMS)
    fit = [t for t in reversed(THREADS) if wave * t <= RESIDENT_THREADS]
    return tuple(fit) or (THREADS[0],)


@functools.lru_cache(maxsize=None)
def cross_i8_plan(BH: int, S: int, cluster: Optional[int] = None,
                  threads: Optional[int] = None) -> dict:
    """The kernel's launch plan for ``BH`` (batch, head) rows of ``S``
    positions (cached: treat it as read-only).

    Each row is a thread-block cluster of ``cluster`` blocks of ``threads``
    threads; block r owns the positions :func:`block_range` (``R =
    ceil(S / cluster)`` of them).  The plan takes the smallest cluster that
    launches at least :data:`TARGET_BLOCKS` blocks (at most 8, and no more
    blocks than positions) and the most threads a block that keep every
    block of that grid resident at once (``RESIDENT_THREADS`` an SM); where
    a block's positions do not fit its shared memory, fewer threads, then
    larger clusters.  Shared memory (bytes): a K slot of ``threads`` rows
    of 64, then four arrays of ``R`` (rounded up to 4) words: K scales, V
    scales, logits, and the mask bytes, then the V rows listed; the slot
    and the scales hold V rows once the weights are known.  Raises
    ValueError for a shape it cannot hold: no rows, S past :data:`MAX_S`,
    a cluster or thread count outside what the kernel is built for, shared
    memory past a block's, a grid past 2^31 - 1."""
    if BH < 1 or not 1 <= S <= MAX_S:
        raise ValueError(f"cross_attention_i8 kernel: no plan for {BH} rows of S {S} "
                         f"(S within 1..{MAX_S})")
    room = SMEM_MAX - STATIC_SMEM
    if cluster is None:
        fits = [c for c in CLUSTERS if c == 1 or c <= S]
        first = next((i for i, c in enumerate(fits) if BH * c >= TARGET_BLOCKS),
                     len(fits) - 1)
        clusters = fits[first:]
    else:
        clusters = [cluster]
    choices = [(c, t) for c in clusters
               for t in ((threads,) if threads else _resident_threads(BH * c))]
    cluster, threads = next(((c, t) for c, t in choices
                             if _smem(t, -(-S // c)) <= room), choices[0])
    if cluster not in CLUSTERS or threads not in THREADS:
        raise ValueError(f"cross_attention_i8 kernel: no plan of {cluster} blocks a "
                         f"cluster, {threads} threads")
    R = -(-S // cluster)
    smem = _smem(threads, R)
    if smem > room:
        raise ValueError(f"cross_attention_i8 kernel: no plan for S {S} in clusters of "
                         f"{cluster}: {smem} bytes of shared memory a block")
    blocks = BH * cluster
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"cross_attention_i8 kernel: {BH} rows in clusters of {cluster} "
                         f"need {blocks} blocks, more than a grid holds")
    return {"BH": BH, "S": S, "cluster": cluster, "threads": threads, "rows": R,
            "blocks": blocks, "blocks_per_sm": _blocks_per_sm(blocks, threads, smem),
            "smem_bytes": smem}


def cross_i8_plan_ints(plan: dict) -> list:
    """The plan as ``cross_attn_i8`` takes it."""
    return [plan[k] for k in ("cluster", "threads", "rows", "smem_bytes")]


_PlanInts = ctypes.c_int * 4


def plan_arg(plan: dict):
    """The plan as a C array of ints."""
    return _PlanInts(*cross_i8_plan_ints(plan))


@functools.lru_cache(maxsize=None)
def _plan_arg(BH: int, S: int):
    return plan_arg(cross_i8_plan(BH, S))


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry, its library built at first use."""
    fn = build.load("cross_attention_i8").cross_attn_i8
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _kernel_cross_attention_i8(q, k_c, v_c, kv_mask=None, codes=None, plan=None):
    """Launch the CUDA kernel: a cluster of blocks per (b, h), under
    :func:`cross_i8_plan` (``plan``, else the plan of the shape).
    ``codes``, an int8 ``[B, H, S]`` tensor or None, receives the weights'
    codes ``wq`` (for the checks against the plain version)."""
    B, H, S = _check_args(q, k_c, v_c, kv_mask)
    arg = _plan_arg(B * H, S) if plan is None else plan_arg(plan)
    tensors = [q, k_c["q"], k_c["s"], v_c["q"], v_c["s"]]
    if kv_mask is not None:
        tensors.append(kv_mask)
    if codes is not None:
        if codes.dtype != torch.int8 or codes.shape != (B, H, S) or not codes.is_contiguous():
            raise ValueError("cross_attention_i8 kernel: codes must be a "
                             "contiguous int8 [B, H, S]")
        tensors.append(codes)
    for t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"cross_attention_i8 kernel: every tensor must lie "
                             f"on one CUDA device, got {t.device}")
    fn = _entry()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_c["q"].data_ptr(), k_c["s"].data_ptr(),
            v_c["q"].data_ptr(), v_c["s"].data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            None if codes is None else codes.data_ptr(),
            _DTYPES[q.dtype], B, H, S, arg, stream)
    build.check(rc, "cross_attn_i8")
    cross_attention_i8.launches += 1
    return out


def cross_attention_i8(q, k_c, v_c, kv_mask: Optional[torch.Tensor] = None):
    """The int8-direct core: q ``[B, H, 1, Dh]`` scaled, int8 caches of one
    layer, kv_mask ``[B, S]`` bool or None -> ``[B, H, 1, Dh]`` in q's
    dtype.  The kernel on a CUDA tensor (it raises on what it does not
    take), the plain version on a CPU tensor."""
    if q.device.type == "cuda":
        return _kernel_cross_attention_i8(q, k_c, v_c, kv_mask)
    return _plain_cross_attention_i8(q, k_c, v_c, kv_mask)


cross_attention_i8.launches = 0
