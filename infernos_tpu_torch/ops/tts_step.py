"""SpeechT5 decoder step: one persistent CUDA kernel and its plain PyTorch version.

``fused_decode_step`` replaces ``speecht5.decode_step`` in the TTS engine.
On CUDA tensors it runs ``csrc/tts_step.cu`` (the port of
``infernos_tpu/ops/tts_step.py::_layer_kernel``): the whole step, every
product and every attention of every layer, is ONE cooperative launch that
walks the layers' phases between grid barriers, with each block's weights
streamed ahead of it into shared memory.  On CPU tensors it runs
:func:`_plain_decode_step`, which repeats the same arithmetic in fp32
PyTorch.  There is no fallback from the kernel to the plain path.

Both update the self K/V caches in place at each slot's ``pos`` (no cache
copy) and return the new hidden state.  The step is memory-bound (weights
plus caches, see the source note in ``csrc/tts_step.cu``).  Weights are
packed once, at engine init, by :func:`pack_fused_weights`: packing inside
the step would re-read and re-write every weight each step.  On the card
the big matrices are packed into "panels" (:func:`pack_panels`), the
kernel's layout; the plain version reads them through the inverse.

Two weight modes, as the Pallas kernel has them.  A dense tree packs to
bf16 matrices.  A tree quantized by ``models/quant.py`` (``w_q``/``scale``
leaves in the decoder layers) packs to the int8 codes themselves plus one
fp32 scale per output channel, and the step computes
``(h @ codes) * scale + bias`` for every product: on the card through
``tts_decode_step_int8`` of the same source, on the CPU through the plain
version.  There is no route from a quantized tree to the bf16 kernels by
dequantizing.  Each mode counts its own launches
(``fused_decode_step.launches`` and ``.launches_int8``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from ..models import layers as L
from . import build

NEG_INF = -1e9

PackedWeights = Dict[str, torch.Tensor]

_GEMMS = ("wqkv", "wso", "wcq", "wco", "w1", "w2")  # the kernel's order
_BIASES = ("bqkv", "bso", "bcq", "bco", "b1", "b2")
_SCALES = ("sqkv", "sso", "scq", "sco", "s1", "s2")  # int8 mode only
_LNS = ("ln1g", "ln1b", "ln2g", "ln2b", "ln3g", "ln3b")
LAUNCHES_PER_STEP = 1  # CUDA launches of one kernel step, both modes
MAX_B = 32  # most slots one step takes
MAX_T = 4096  # longest self or cross cache the attention phases take
HEAD_DIM = 64
TILE = 16  # a weight tile is 16 output columns x 16 input rows
MAX_SPLITS = 8  # most K splits of one product (the kernel's partial-sum registers)


# -- the panel layout -------------------------------------------------------------

def _frag_order() -> torch.Tensor:
    """Where each of a 16 x 16 tile's 256 elements goes: entry ``8 * lane +
    e`` is ``m * 16 + k`` of the element (output column m, input row k) that
    lane ``lane`` holds as element ``e`` of its A fragment of
    ``mma.sync.m16n8k16`` (rows g and g + 8, columns 2t, 2t + 1, 2t + 8,
    2t + 9, with g = lane // 4 and t = lane % 4)."""
    idx = []
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(8):
            idx.append((g + 8 * (e // 2 % 2)) * TILE + 2 * t + e % 2 + 8 * (e // 4))
    return torch.tensor(idx)


_ORDER = _frag_order()


def pack_panels(w: torch.Tensor) -> torch.Tensor:
    """``[L, K, N]`` -> ``[L, N / 16, K / 16, 256]``: panel j holds output
    columns 16j..16j+15, each of its K / 16 tiles 16 input rows in the A
    fragment order of ``mma.sync`` (:func:`_frag_order`).  One block's
    share of a product (a few panels, a range of rows) is then a few
    contiguous byte ranges, each one bulk copy, and each lane reads its
    fragment of a tile with one 16-byte (bf16) or 8-byte (int8) load."""
    Lyr, K, N = w.shape
    t = w.reshape(Lyr, K // TILE, TILE, N // TILE, TILE).permute(0, 3, 1, 4, 2)
    t = t.reshape(Lyr, N // TILE, K // TILE, TILE * TILE)
    return t[..., _ORDER.to(w.device)].contiguous()


def unpack_panels(p: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_panels`: ``[L, K, N]``, exactly."""
    Lyr, P, KT, _ = p.shape
    t = torch.empty_like(p)
    t[..., _ORDER.to(p.device)] = p
    t = t.reshape(Lyr, P, KT, TILE, TILE).permute(0, 2, 4, 1, 3)
    return t.reshape(Lyr, KT * TILE, P * TILE)


def _rows(fw: PackedWeights, name: str) -> torch.Tensor:
    """Matrix ``name`` as ``[L, K, N]``, whatever its packed layout."""
    w = fw[name]
    return unpack_panels(w) if w.dim() == 4 else w


def pack_fused_weights(params, cfg, dtype: Optional[torch.dtype] = None) -> PackedWeights:
    """Decoder weights in the kernel's layouts (do this once).

    Dense tree: big matrices ``[L, in, out]`` in ``dtype`` (default: the
    params' own), with 1/sqrt(Dh) folded into the self q third of ``wqkv``
    and into the cross-q weights and biases; biases and LayerNorm parameters
    fp32.

    Quantized tree (``w_q`` in ``dec_layers.self_attn.q``): the same keys
    with the int8 codes untouched (``dtype`` does not apply to them), plus
    fp32 scales ``sqkv [L, 3D]``, ``sso``, ``scq``, ``sco``, ``s2 [L, D]``
    and ``s1 [L, F]``; 1/sqrt(Dh) is folded into the q third of ``sqkv``,
    into ``scq`` and into the q biases.

    Params on a CUDA device get the six big matrices packed by
    :func:`pack_panels`, the layout the kernel reads; the CPU keeps
    ``[L, in, out]``.
    """
    dl = params["dec_layers"]
    sa, ca, ffn = dl["self_attn"], dl["cross_attn"], dl["ffn"]
    D = sa["q"]["b"].shape[1]
    scale = (D // cfg.decoder_attention_heads) ** -0.5
    int8w = "w_q" in sa["q"]
    if not int8w:
        dtype = dtype or sa["q"]["w"].dtype

    def w(node, s=1.0):
        if int8w:  # codes untouched: ``s`` goes into the node's scales below
            return node["w_q"].contiguous()
        return (node["w"].float() * s).to(dtype).contiguous()

    def f(t, s=1.0):
        return (t.float() * s).contiguous()

    fw = {
        "wqkv": torch.cat([w(sa["q"], scale), w(sa["k"]), w(sa["v"])],
                          dim=2).contiguous(),
        "bqkv": torch.cat([f(sa["q"]["b"], scale), f(sa["k"]["b"]),
                           f(sa["v"]["b"])], dim=1).contiguous(),
        "wso": w(sa["o"]), "bso": f(sa["o"]["b"]),
        "wcq": w(ca["q"], scale), "bcq": f(ca["q"]["b"], scale),
        "wco": w(ca["o"]), "bco": f(ca["o"]["b"]),
        "w1": w(ffn["in"]), "b1": f(ffn["in"]["b"]),
        "w2": w(ffn["out"]), "b2": f(ffn["out"]["b"]),
        **{f"{n}{s}": f(dl[n][k]) for n in ("ln1", "ln2", "ln3")
           for s, k in (("g", "g"), ("b", "b"))},
    }
    if int8w:
        fw.update({
            "sqkv": torch.cat([f(sa["q"]["scale"], scale), f(sa["k"]["scale"]),
                               f(sa["v"]["scale"])], dim=1).contiguous(),
            "sso": f(sa["o"]["scale"]), "scq": f(ca["q"]["scale"], scale),
            "sco": f(ca["o"]["scale"]), "s1": f(ffn["in"]["scale"]),
            "s2": f(ffn["out"]["scale"]),
        })
    if sa["q"]["b"].device.type == "cuda":
        fw.update({n: pack_panels(fw[n]) for n in _GEMMS})
    return fw


def is_int8(fw: PackedWeights) -> bool:
    """Whether ``fw`` was packed from a quantized tree."""
    return fw["wqkv"].dtype == torch.int8


def _mask_add(enc_mask, B, S):
    if enc_mask is None:
        return None
    return torch.where(enc_mask.bool(), 0.0, NEG_INF).to(
        torch.float32).reshape(B, S).contiguous()


def _ln(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _plain_decode_step(fw: PackedWeights, cfg, x, cache, pos, enc_mask=None):
    """The kernel's arithmetic in fp32 PyTorch: same packed weights (panels
    read through their inverse), same in-place cache writes (in the cache's
    dtype, read back before use).  int8 mode: ``(h @ codes) * scale +
    bias``, the kernel's order."""
    B = x.shape[0]
    H = cfg.decoder_attention_heads
    eps = cfg.layer_norm_eps
    h = x[:, 0].float()
    D = h.shape[-1]
    Dh = D // H
    S = cache.cross_k.shape[3]
    madd = _mask_add(enc_mask, B, S)
    int8w = is_int8(fw)
    mats = {n: _rows(fw, n) for n in _GEMMS}

    def mm(a, w, sc, b, l):
        y = a @ mats[w][l].float()
        if int8w:
            y = y * fw[sc][l]
        return y + fw[b][l]

    for l in range(mats["wqkv"].shape[0]):
        y = mm(h, "wqkv", "sqkv", "bqkv", l)
        q, k, v = (y[:, i * D:(i + 1) * D].reshape(B, H, Dh) for i in range(3))
        wp = L.write_rows(cache.self_k[l], k, pos)
        L.write_rows(cache.self_v[l], v, pos)
        T = cache.self_k.shape[3]
        logits = torch.einsum("bhd,bhtd->bht", q, cache.self_k[l].float())
        valid = torch.arange(T, device=h.device)[None, :] <= wp[:, None]
        logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
        a = torch.einsum("bht,bhtd->bhd", torch.softmax(logits, -1),
                         cache.self_v[l].float()).reshape(B, D)
        h = _ln(h + mm(a, "wso", "sso", "bso", l),
                fw["ln1g"][l], fw["ln1b"][l], eps)
        qc = mm(h, "wcq", "scq", "bcq", l).reshape(B, H, Dh)
        logits = torch.einsum("bhd,bhsd->bhs", qc, cache.cross_k[l].float())
        if madd is not None:
            logits = logits + madd[:, None, :]
        a = torch.einsum("bhs,bhsd->bhd", torch.softmax(logits, -1),
                         cache.cross_v[l].float()).reshape(B, D)
        h = _ln(h + mm(a, "wco", "sco", "bco", l),
                fw["ln2g"][l], fw["ln2b"][l], eps)
        f = L.gelu(mm(h, "w1", "s1", "b1", l))
        h = _ln(h + mm(f, "w2", "s2", "b2", l),
                fw["ln3g"][l], fw["ln3b"][l], eps)
    return h.to(x.dtype)[:, None, :]


# -- the launch plan ----------------------------------------------------------------

SMEM_MAX = 232448  # bytes of shared memory one block may hold on Hopper
NWARPS = 8  # warps of a block
MAX_SLOTS = 6  # most weight slices a block holds in its ring (one layer's)
SMALL_BYTES = 1024  # mbarriers, LN statistics, flags
ATTN_BYTES = (3 * HEAD_DIM + MAX_T + NWARPS + NWARPS * HEAD_DIM) * 4  # one attention item
SLOT_VEC = 128 * 4  # a slot ends in its item's bias and scale (128 columns at most)
LN_BYTES = (4096 + NWARPS) * 4  # the last LayerNorm's row buffer
# Up to PLAN_CAP_SLOTS slots, fewer K splits and larger items: each split
# costs the last block of a column group a pass over partial sums, while the
# larger copies start at a grid barrier, off the block's path.  With more
# slots each item's x staging and products grow, and the smallest items
# spread them best.  On an H100 this rule's plan is the fastest measured, or
# within 1% of it, at 8, 12, 16, 20, 24 and 32 slots in both modes
# (ops/tts_step_ablate.py).
PLAN_MAX_TILES = 64
PLAN_CAP_SLOTS = 16
_BY_SLOTS = -1  # step_plan's default cap: PLAN_MAX_TILES up to PLAN_CAP_SLOTS, then none


def gemm_shapes(D: int, F: int):
    """(K, N) of the step's six products, in the kernel's order."""
    return ((D, 3 * D), (D, D), (D, D), (D, D), (D, F), (F, D))


def gemm_choice(K: int, N: int, grid: int, max_tiles: Optional[int] = None):
    """(panels per item G, K splits) of one ``[B, K] @ [K, N]`` product on
    ``grid`` blocks.  An item is G panels of 16 columns over one of the
    splits' row ranges; there are at most ``grid`` items, one per block.
    Without ``max_tiles`` the choice makes the largest item (the bytes one
    block must stream) smallest, then takes the fewest splits; with it, it
    takes the fewest splits (each split costs the last block a pass over
    the partial sums) whose items hold at most ``max_tiles`` tiles."""
    P, KT = N // TILE, K // TILE
    best = None
    for G in (1, 2, 4, 8):  # warps: G panels x 8 / G row ranges
        groups = -(-P // G)
        if groups > grid:
            continue
        most = max(1, min(KT, MAX_SPLITS, grid // groups))
        if max_tiles is None:
            splits = most
            cost = (G * -(-KT // splits), splits)
        else:
            splits = next((s for s in range(1, most + 1)
                           if G * -(-KT // s) <= max_tiles), None)
            if splits is None:
                continue
            cost = (splits, G * -(-KT // splits))
        if best is None or cost < best[0]:
            best = (cost, G, splits)
    if best is None and max_tiles is not None:  # none that small: the fewest tiles
        return gemm_choice(K, N, grid)
    if best is None:
        raise ValueError(f"tts_step kernel: no plan for [{K}, {N}] on {grid} blocks")
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def step_plan(B: int, D: int, F: int, int8w: bool, grid: int,
              max_tiles: Optional[int] = _BY_SLOTS) -> dict:
    """The launch plan of one step: per product its (G, splits, items), the
    weight ring (slots and bytes a slot) and the shared-memory layout, as
    ``csrc/tts_step.cu`` lays it out (cached: treat it as read-only).
    ``max_tiles`` (see :func:`gemm_choice`) caps the tiles of an item, by
    default ``PLAN_MAX_TILES`` up to ``PLAN_CAP_SLOTS`` slots and none
    beyond; where two slots of such items do not fit, and with None, the
    plan takes the smallest items.  Raises ValueError when two slots of
    those do not fit."""
    if max_tiles == _BY_SLOTS:
        max_tiles = PLAN_MAX_TILES if B <= PLAN_CAP_SLOTS else None
    try:
        return _plan(B, D, F, int8w, grid, max_tiles)
    except ValueError:
        if max_tiles is None:
            raise
        return _plan(B, D, F, int8w, grid, None)


def _plan(B: int, D: int, F: int, int8w: bool, grid: int,
          max_tiles: Optional[int]) -> dict:
    esz = 1 if int8w else 2
    bpad = -(-B // 8) * 8
    gemms = []
    for K, N in gemm_shapes(D, F):
        G, splits = gemm_choice(K, N, grid, max_tiles)
        groups = -(-(N // TILE) // G)
        max_nkt = -(-(K // TILE) // splits)
        gemms.append({"K": K, "N": N, "G": G, "splits": splits, "groups": groups,
                      "items": groups * splits, "max_nkt": max_nkt})
    slot = max(g["G"] * g["max_nkt"] * TILE * TILE * esz for g in gemms)
    slot = -(-slot // 128) * 128 + 2 * SLOT_VEC
    xs_stride = TILE * max(g["max_nkt"] for g in gemms) + 8  # bf16 x rows, padded
    xs_bytes = -(-bpad * xs_stride * 2 // 16) * 16
    red_bytes = NWARPS * bpad * TILE * 4  # per-warp partial products
    fin_bytes = bpad * 8 * TILE * 4  # finished rows of one item (LN sums)
    work = max(xs_bytes + red_bytes + fin_bytes, ATTN_BYTES, LN_BYTES)
    work = -(-work // 128) * 128
    nslot = min(MAX_SLOTS, (SMEM_MAX - work - SMALL_BYTES) // slot)
    if nslot < 2:
        raise ValueError(f"tts_step kernel: a weight slice of {slot} bytes "
                         "leaves no room for two in shared memory")
    return {"grid": grid, "gemms": gemms, "nslot": nslot, "slot_bytes": slot,
            "xs_stride": xs_stride, "work_bytes": work,
            "smem_bytes": nslot * slot + work + SMALL_BYTES}


def plan_ints(plan: dict) -> list:
    """The plan as the C entry point takes it."""
    return [v for g in plan["gemms"] for v in (g["G"], g["splits"])] + [
        plan["nslot"], plan["slot_bytes"], plan["xs_stride"], plan["work_bytes"],
        plan["smem_bytes"]]


# -- the launch -----------------------------------------------------------------------

def _check_step_args(fw: PackedWeights, x, cache, pos, enc_mask):
    """Shapes and dtypes the kernel takes, checked before the device (so
    the CPU tests reach every refusal); returns ``(L, B, H, T, S, D, F)``."""
    int8w = is_int8(fw)
    wdt = torch.int8 if int8w else torch.bfloat16
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        t = getattr(cache, name)
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.dim() != 5:
            raise ValueError(f"tts_step kernel: cache.{name} must be a "
                             "contiguous bf16 [L, B, H, T, 64] tensor")
    for name in _GEMMS + _BIASES + _LNS + (_SCALES if int8w else ()):
        t = fw[name]
        want = wdt if name in _GEMMS else torch.float32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"tts_step kernel: packed {name} must be "
                             f"contiguous {want}")
    Lyr, B, H, T, Dh = cache.self_k.shape
    S = cache.cross_k.shape[3]
    D = H * Dh
    F = fw["b1"].shape[1]
    if not 1 <= B <= MAX_B:
        raise ValueError(f"tts_step kernel: {B} slots; it takes 1 to {MAX_B}")
    if T > MAX_T or S > MAX_T:
        raise ValueError(f"tts_step kernel: caches of T {T}, S {S}; it takes "
                         f"at most {MAX_T}")
    if (Dh != HEAD_DIM or F % TILE
            or cache.self_v.shape != cache.self_k.shape
            or cache.cross_k.shape != (Lyr, B, H, S, Dh)
            or cache.cross_v.shape != cache.cross_k.shape):
        raise ValueError("tts_step kernel: unsupported shape "
                         f"cache {tuple(cache.self_k.shape)}, F {F}")
    for name, (K, N) in zip(_GEMMS, gemm_shapes(D, F)):
        if fw[name].shape != (Lyr, N // TILE, K // TILE, TILE * TILE):
            raise ValueError(f"tts_step kernel: packed {name} must be panels "
                             f"[{Lyr}, {N // TILE}, {K // TILE}, 256] "
                             "(pack_fused_weights on the card)")
    if (x.shape != (B, 1, D) or x.dtype not in (torch.float32, torch.bfloat16)
            or not x.is_contiguous()):
        raise ValueError(f"tts_step kernel: x must be a contiguous fp32 or bf16 "
                         f"[{B}, 1, {D}] tensor, got {x.dtype} {tuple(x.shape)}")
    if pos.shape != (B,) or pos.dtype != torch.int64:
        raise ValueError(f"tts_step kernel: pos must be int64 [{B}], got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if enc_mask is not None and (enc_mask.shape != (B, S) or enc_mask.dtype != torch.bool
                                 or not enc_mask.is_contiguous()):
        raise ValueError(f"tts_step kernel: enc_mask must be a contiguous bool "
                         f"[{B}, {S}] tensor or None")
    return Lyr, B, H, T, S, D, F


_scratch: Dict[tuple, Dict[str, torch.Tensor]] = {}


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    """The grid: one block per SM, all resident together."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _step_scratch(dev, stream: int, B: int, D: int, F: int,
                  plan: dict) -> Dict[str, torch.Tensor]:
    """The step's scratch, made once per device, stream and plan: fp32
    residual (two buffers), qkv, attention output, sublayer output, FFN
    middle, split-K partials and the LayerNorm sums of each column group;
    int32 group counters and the grid barrier, zeroed once (the kernel
    leaves them at zero).  Steps sharing it are ordered by their stream;
    steps on two streams never share a barrier or a buffer.  A CUDA graph
    keeps the scratch of the stream it was captured on: warm that stream up
    before the capture, and replay one such graph at a time."""
    key = (dev.index, stream, B, D, F, tuple(plan_ints(plan)))
    sc = _scratch.get(key)
    if sc is None:
        gs = plan["gemms"]
        part = max(g["splits"] * B * g["N"] for g in gs)
        stats = max(g["groups"] for g in gs) * B * 2
        sizes = (2 * B * D, 3 * B * D, B * D, B * D, B * F, part, stats)
        flt = torch.empty(sum(sizes), dtype=torch.float32, device=dev).split(sizes)
        n_cnt = max(g["groups"] for g in gs)
        ints = torch.zeros(n_cnt + 2, dtype=torch.int32, device=dev)
        sc = dict(zip(("hbuf", "y", "a", "t", "mid", "part", "stats"), flt),
                  counters=ints[:n_cnt], bar=ints[n_cnt:])
        _scratch[key] = sc
    return sc


def _launch(fn, fw: PackedWeights, cfg, x, cache, pos, enc_mask, plan: dict,
            trace: Optional[torch.Tensor] = None):
    """Call the C entry point ``fn`` (of ``fw``'s mode) with ``plan`` on
    arguments :func:`_check_step_args` has passed; returns the hidden state
    (a new tensor in x's dtype).  ``trace`` goes to a build with
    ``-DTTS_TRACE`` (``ops/tts_step_ablate.py``)."""
    Lyr, B, H, T, Dh = cache.self_k.shape
    S, D, F = cache.cross_k.shape[3], H * Dh, fw["b1"].shape[1]
    int8w = is_int8(fw)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sc = _step_scratch(x.device, stream, B, D, F, plan)
    out = torch.empty_like(x)
    scales = [fw[n] if int8w else None for n in _SCALES]
    ptrs = [x, out, pos, enc_mask, *(fw[n] for n in _GEMMS),
            *(fw[n] for n in _BIASES), *scales, *(fw[n] for n in _LNS),
            cache.self_k, cache.self_v, cache.cross_k, cache.cross_v,
            *(sc[n] for n in ("hbuf", "y", "a", "t", "mid", "part", "stats",
                              "counters", "bar")), *([trace] if trace is not None else [])]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(
        *(None if t is None else t.data_ptr() for t in ptrs))
    dims = (ctypes.c_int * 7)(Lyr, B, H, T, S, F, int(x.dtype == torch.bfloat16))
    ints = plan_ints(plan)
    rc = fn(c_ptrs, dims, (ctypes.c_int * len(ints))(*ints),
            float(cfg.layer_norm_eps), plan["grid"], stream)
    build.check(rc, "tts_decode_step_int8" if int8w else "tts_decode_step")
    return out


def _kernel_decode_step(fw: PackedWeights, cfg, x, cache, pos, enc_mask=None):
    """One launch of the step kernel; same contract as
    :func:`_plain_decode_step`.  int8 codes go to ``tts_decode_step_int8``
    with their scales, bf16 weights to ``tts_decode_step``; anything else
    raises.  x is read as given and the hidden state comes back in x's
    dtype; pos is read as int64 and the bool mask as it is.  The launch is
    cooperative, one block per SM."""
    Lyr, B, H, T, S, D, F = _check_step_args(fw, x, cache, pos, enc_mask)
    dev = x.device
    tensors = [x, pos, *(getattr(cache, n) for n in ("self_k", "self_v", "cross_k",
                                                      "cross_v"))]
    if enc_mask is not None:
        tensors.append(enc_mask)
    if dev.type != "cuda" or any(t.device != dev for t in tensors) \
            or any(fw[n].device != dev for n in _GEMMS):
        raise ValueError("tts_step kernel: tensors must be on one CUDA device")
    int8w = is_int8(fw)
    lib = build.load("tts_step")
    fn = lib.tts_decode_step_int8 if int8w else lib.tts_decode_step
    out = _launch(fn, fw, cfg, x, cache, pos, enc_mask,
                  step_plan(B, D, F, int8w, _sm_count(dev)))
    if int8w:
        fused_decode_step.launches_int8 += 1
    else:
        fused_decode_step.launches += 1
    return out


def fused_decode_step(params, cfg, x, cache, pos, enc_mask=None, *,
                      packed: Optional[PackedWeights] = None):
    """One AR decoder step for all slots (drop-in for
    ``speecht5.decode_step``): x ``[B, 1, D]``, pos ``[B]``, canonical
    caches ``[L, B, H, T, Dh]`` (self K/V updated in place at ``pos``),
    enc_mask ``[B, S]`` bool or None.  Returns the ``[B, 1, D]`` hidden.

    On the card x must be fp32 or bf16, pos int64 and enc_mask bool, as the
    engine gives them, and B at most 32 with T and S at most 4096; anything
    else raises ValueError.  The CPU path is more lenient (any integer pos,
    a mask that ``.bool()`` reads); callers that may run on either device
    keep to the card's terms.

    ``packed``: weights from :func:`pack_fused_weights` (pack once, outside
    any loop; without it the step packs on every call).
    """
    if x.device.type == "cuda":
        fw = packed if packed is not None else pack_fused_weights(
            params, cfg, torch.bfloat16)
        return _kernel_decode_step(fw, cfg, x, cache, pos, enc_mask)
    fw = packed if packed is not None else pack_fused_weights(params, cfg)
    return _plain_decode_step(fw, cfg, x, cache, pos, enc_mask)


fused_decode_step.launches = 0  # bf16 kernel steps (one launch each)
fused_decode_step.launches_int8 = 0  # int8 kernel steps (one launch each)
