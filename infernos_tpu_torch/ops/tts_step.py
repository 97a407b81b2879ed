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
dequantizing.

Two cache modes, as the Pallas kernel takes its cache dtypes from the
caches: bf16 caches (the full-width engines on the card), or fp32 caches
(the tiny and tiny-real engines), whose K/V rows are written and read in
fp32.  The weights stay bf16 or int8 codes in both, as the reference's
``wdt`` packs them (:func:`pack_fused_weights`).  The fp32-cache modes
run a kernel of their own, ``csrc/tts_step_cluster.cu``, designed for the
tiny-real step they serve: one thread-block cluster per group of at most
``CLUSTER_ROWS`` slots keeps the hidden state in shared memory
(:func:`cluster_plan`).  Each of the four modes counts its own launches:
``fused_decode_step.launches`` (bf16 weights, bf16 caches),
``.launches_int8``, ``.launches_fp32`` (bf16 weights, fp32 caches) and
``.launches_int8_fp32``.

One launch of the grid kernel (bf16 caches) takes at most ``MAX_B``
slots.  A step of more slots runs it once per group of at most ``MAX_B``
slots, in slot order, on the caller's stream (:func:`run_groups`): each
launch reads its slots of the caches in place.  The cluster kernel (fp32
caches) takes any number of slots in one launch, a cluster per slot
group.  :func:`launches_per_step` gives the launches of a step by mode.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
MAX_B = 32  # most slots one launch takes
MAX_T = 4096  # longest self or cross cache the attention phases take
HEAD_DIM = 64
TILE = 16  # a weight tile is 16 output columns x 16 input rows
MAX_SPLITS = 8  # most K splits of one product (the kernel's partial-sum registers)


_CACHES = ("self_k", "self_v", "cross_k", "cross_v")


def launches_per_step(B: int, fp32_caches: bool = False) -> int:
    """Kernel launches of one step of ``B`` slots: over bf16 caches one per
    group of at most ``MAX_B`` slots, over fp32 caches one (the cluster
    kernel's clusters take every slot group)."""
    return 1 if fp32_caches else -(-B // MAX_B)


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
    fp32.  Params on a CUDA device pack their matrices in bf16 whatever
    ``dtype`` or their own dtype is: the kernel's weights, as the
    reference packs them (``wdt=jnp.bfloat16``).  On the CPU the plain
    step keeps ``dtype``, as the reference's CPU path never rounds them.

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
    on_card = sa["q"]["b"].device.type == "cuda"
    if not int8w:
        dtype = torch.bfloat16 if on_card else dtype or sa["q"]["w"].dtype

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
    if on_card:
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


# -- the cluster kernel's plan (fp32 caches) ---------------------------------------

CLUSTER_ROWS = 8  # most slots one cluster owns (the products' n8 column tile)
# Up to CLUSTER_SPREAD_SLOTS slots, clusters of at most 4 slots: more SMs
# (and their L2 bandwidth) for the attention items, one item a block at
# the tiny-real width; beyond, 8 (fewer clusters than the card holds at once).
CLUSTER_SPREAD_SLOTS = 16
CLUSTER_SIZE = 16  # blocks a cluster (non-portable above 8; the card's GPCs hold 16)
CLUSTER_MAX_PAIRS = 32  # (panel, K range) pairs of one block's product
CLUSTER_MAX_NP = 16  # most panels of one product a block owns
CLUSTER_MAX_SLOTS = 8  # most weight slots a block's ring holds
CLUSTER_MAX_ITEMS = 16  # attention items a block owns at most
# per-warp sums, the items' rows, the mbarriers (LayerNorm, biases, the ring's),
# the block's share of each product
CLUSTER_SMALL = (NWARPS * HEAD_DIM + 2 * NWARPS + CLUSTER_MAX_ITEMS) * 4 + \
    (CLUSTER_MAX_SLOTS + 2) * 8 + len(_GEMMS) * 9 * 4


def k_splits(np_: int) -> int:
    """K ranges a block's ``np_`` panels of a product are cut into over its
    8 warps: as many as give every warp the same number of (panel, range)
    pairs, at most ``CLUSTER_MAX_PAIRS`` pairs (``k_splits`` of the source)."""
    g = 8
    while np_ % g:
        g //= 2
    q = NWARPS // g
    while np_ * q > CLUSTER_MAX_PAIRS and q > 1:
        q //= 2
    return q


def _a128(n: int) -> int:
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=None)
def cluster_plan(B: int, D: int, F: int, L: int, int8w: bool, csize: int = CLUSTER_SIZE,
                 rows: Optional[int] = None) -> dict:
    """The cluster kernel's launch plan for a step of ``B`` slots through
    ``L`` layers of width ``D`` (FFN ``F``), as ``csrc/tts_step_cluster.cu``
    reads it (cached: treat it as read-only).

    ``ceil(B / rows)`` clusters of ``csize`` blocks own the slots in groups
    of equal size (the last one smaller), ``rows`` by default 4 up to
    ``CLUSTER_SPREAD_SLOTS`` slots and 8 beyond; block r of a cluster owns panels
    ``[r P / csize, (r + 1) P / csize)`` of each product of P panels (all
    K), split over its warps into ``k_splits`` K ranges, and the cluster's
    (slot, head) items ``r, r + csize, ...``, a team of warps each.  Its
    shared memory holds a ring of weight slots (a slot a chunk of K tiles
    of the block's panels), the residual and the gathered h + y in fp32,
    the two bf16 input-row buffers, its items' q, k and v, the per-pair
    partial sums, the per-warp attention sums, the next LayerNorm's
    parameters and the biases (and int8 scales) of its columns of every
    product of every layer.  Raises ValueError where a shape
    does not fit: a block finishing more than ``CLUSTER_MAX_NP`` panels of
    a product (N > 4096 at 16 blocks), or state leaving no room for two
    ring slots in 232,448 bytes.  SpeechT5's full width (D 768, F 3072)
    fits at 8 slots a cluster."""
    if rows is None:
        rows = 4 if B <= CLUSTER_SPREAD_SLOTS else CLUSTER_ROWS
    if B < 1 or rows < 1 or rows > CLUSTER_ROWS or csize < 1 or csize > 16 or D % HEAD_DIM:
        raise ValueError(f"tts_step cluster kernel: no plan for B {B}, D {D}, "
                         f"{rows} slots and {csize} blocks a cluster")
    H = D // HEAD_DIM
    clusters = -(-B // rows)
    rows = -(-B // clusters)  # the groups as equal as they come
    esz = 1 if int8w else 2
    gemms = []
    for K, N in gemm_shapes(D, F):
        P, KT = N // TILE, K // TILE
        shares = [(r * P // csize, (r + 1) * P // csize - r * P // csize)
                  for r in range(csize)]
        np_max = max(n for _, n in shares)
        if np_max > CLUSTER_MAX_NP:
            raise ValueError(
                f"tts_step cluster kernel: a product of {N} columns gives a block "
                f"{np_max} panels of 16 at {csize} blocks a cluster; it takes at most "
                f"{CLUSTER_MAX_NP} (N <= {CLUSTER_MAX_NP * TILE * csize})")
        gemms.append({"K": K, "N": N, "P": P, "KT": KT, "shares": shares,
                      "np_max": np_max, "pairs": max(n * k_splits(n) for _, n in shares if n)})
    ipb = -(-rows * H // csize)
    if ipb > CLUSTER_MAX_ITEMS:
        raise ValueError(f"tts_step cluster kernel: {ipb} attention items a block; "
                         f"it takes at most {CLUSTER_MAX_ITEMS}")
    teams = 1
    while teams < min(ipb, NWARPS):
        teams *= 2
    xs0_stride = D + 8
    xs1_stride = max(D, F) + 8
    sizes = {"h": rows * D * 4, "pre": rows * D * 4,
             "xs0": CLUSTER_ROWS * xs0_stride * 2, "xs1": CLUSTER_ROWS * xs1_stride * 2,
             "qkv": ipb * 3 * HEAD_DIM * 4,
             "red": max(g["pairs"] for g in gemms) * TILE * CLUSTER_ROWS * 4,
             "ln": 2 * D * 4,
             "bias": L * sum(g["np_max"] * TILE for g in gemms) * 4 * (2 if int8w else 1),
             "small": CLUSTER_SMALL}
    fixed = sum(_a128(v) for v in sizes.values())
    np_all = max(g["np_max"] for g in gemms)
    top = max(g["np_max"] * g["KT"] for g in gemms)  # a whole product a slot

    def slot_bytes(t):  # the largest chunk of t tiles at most, over every share
        return _a128(max(n * min(g["KT"], t // n) for g in gemms for _, n in g["shares"]
                         if n) * TILE * TILE * esz)

    cands, t = [], top
    while t >= np_all and (not cands or t < cands[-1]):
        cands.append(t)
        t = max(np_all, t // 2) if t > np_all else t - 1
    choice = None
    for need in (3, 2):  # the largest slots that leave three in the ring, else two
        for t in cands:
            nslot = min(CLUSTER_MAX_SLOTS, (SMEM_MAX - fixed) // slot_bytes(t))
            if nslot >= need:
                choice = (t, nslot)
                break
        if choice:
            break
    if choice is None:
        raise ValueError(f"tts_step cluster kernel: the state of D {D}, F {F} at "
                         f"{rows} slots a cluster ({fixed} bytes) leaves no room for two "
                         f"weight slots of {slot_bytes(np_all)} bytes in {SMEM_MAX}")
    t, nslot = choice
    offs, at = {}, nslot * slot_bytes(t)
    for k, v in sizes.items():
        offs[k] = at
        at += _a128(v)
    return {"B": B, "D": D, "F": F, "L": L, "H": H, "rows": rows, "csize": csize,
            "clusters": clusters, "teams": teams, "ipb": ipb, "nslot": nslot,
            "slot_bytes": slot_bytes(t), "slot_tiles": t, "offsets": offs, "sizes": sizes,
            "xs0_stride": xs0_stride, "xs1_stride": xs1_stride, "smem_bytes": at,
            "gemms": gemms}


def cluster_plan_ints(plan: dict) -> list:
    """The plan as ``tts_decode_step_fp32`` takes it."""
    o = plan["offsets"]
    return [plan[k] for k in ("rows", "csize", "clusters", "teams", "ipb", "nslot",
                              "slot_bytes", "slot_tiles")] + [
        o[k] for k in ("h", "pre", "xs0", "xs1", "qkv", "red", "ln", "bias", "small")] + [
        plan["xs0_stride"], plan["xs1_stride"], plan["smem_bytes"]]


def cluster_chunks(plan: dict, g: int, rank: int) -> list:
    """Block ``rank``'s chunks of product ``g`` as the kernel copies and
    consumes them: ``(first K tile, K tiles)`` each, over its panels."""
    gm = plan["gemms"][g]
    _, n = gm["shares"][rank]
    if not n:
        return []
    kc = min(gm["KT"], plan["slot_tiles"] // n)
    return [(k0, min(kc, gm["KT"] - k0)) for k0 in range(0, gm["KT"], kc)]


def cluster_items(plan: dict, cluster: int) -> list:
    """The attention items of cluster ``cluster`` as the kernel runs them:
    ``(slot, head, block, index in the block's qkv buffer, team, round)``."""
    R = min(plan["rows"], plan["B"] - cluster * plan["rows"])
    C, teams = plan["csize"], plan["teams"]
    out = []
    for item in range(R * plan["H"]):
        k = item // C
        out.append((cluster * plan["rows"] + item // plan["H"], item % plan["H"],
                    item % C, k, k % teams, k // teams))
    return out


# -- the bound ------------------------------------------------------------------------

def step_bytes(fw: PackedWeights, cache, pos, B: int, with_mask: bool = True) -> float:
    """Bytes one step must move: weights and LN/bias params once, each
    slot's self K/V up to its pos, the whole cross K/V, x in, h out."""
    Lyr, _, H, _, Dh = cache.self_k.shape
    S = cache.cross_k.shape[3]
    D = H * Dh
    w = sum(t.numel() * t.element_size() for t in fw.values())
    rows = float((pos.clamp(max=cache.self_k.shape[3] - 1) + 1).sum().item())
    esz = cache.self_k.element_size()  # bf16 or fp32 caches
    self_kv = 2 * Lyr * H * Dh * esz * rows
    cross_kv = 2 * Lyr * B * H * S * Dh * esz
    return w + self_kv + cross_kv + (B * S * 4 if with_mask else 0) + 2 * B * D * 4


def step_ops(fw: PackedWeights, cache, pos, B: int) -> float:
    """Operations of one step: the products and both attentions."""
    Lyr, _, H, _, Dh = cache.self_k.shape
    S = cache.cross_k.shape[3]
    mats = sum(fw[n].numel() for n in _GEMMS)
    rows = float((pos.clamp(max=cache.self_k.shape[3] - 1) + 1).sum().item())
    return 2.0 * B * mats + 4.0 * Lyr * H * Dh * (rows + B * S)


# -- the launch -----------------------------------------------------------------------

def _check_step_args(fw: PackedWeights, x, cache, pos, enc_mask):
    """Shapes and dtypes the kernel takes, checked before the device (so
    the CPU tests reach every refusal); returns ``(L, B, H, T, S, D, F)``."""
    int8w = is_int8(fw)
    wdt = torch.int8 if int8w else torch.bfloat16
    dts = [getattr(cache, n).dtype for n in _CACHES]
    if len(set(dts)) != 1 or dts[0] not in (torch.bfloat16, torch.float32):
        raise ValueError("tts_step kernel: cache.self_k, cache.self_v, cache.cross_k "
                         "and cache.cross_v must share one dtype, bf16 or fp32; got "
                         + ", ".join(str(d) for d in dts))
    for name in _CACHES:
        t = getattr(cache, name)
        if not t.is_contiguous() or t.dim() != 5:
            raise ValueError(f"tts_step kernel: cache.{name} must be a "
                             "contiguous [L, B, H, T, 64] tensor")
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
    if B < 1:
        raise ValueError(f"tts_step kernel: {B} slots; it takes at least 1")
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


# (int8 weights, the caches' dtype) -> the C entry and its launch counter
_MODES = {(False, torch.bfloat16): ("tts_decode_step", "launches"),
          (True, torch.bfloat16): ("tts_decode_step_int8", "launches_int8"),
          (False, torch.float32): ("tts_decode_step_fp32", "launches_fp32"),
          (True, torch.float32): ("tts_decode_step_int8_fp32", "launches_int8_fp32")}
# the caches' dtype -> the library of its kernel: the grid kernel over bf16
# caches, the cluster kernel over fp32 caches
_LIBRARIES = {torch.bfloat16: "tts_step", torch.float32: "tts_step_cluster"}

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
            trace: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None):
    """Call the C entry point ``fn`` (of ``fw``'s mode) with ``plan`` on
    arguments :func:`_check_step_args` has passed, or on a slot group of
    them (:func:`run_groups`: the caches a slot slice of contiguous caches);
    returns the hidden state, written to ``out`` or to a new tensor in x's
    dtype.  ``trace`` goes to a build with ``-DTTS_TRACE``
    (``ops/tts_step_ablate.py``)."""
    Lyr, B, H, T, Dh = cache.self_k.shape
    bc = cache.self_k.stride(0) // cache.self_k.stride(1)  # the caches' slots
    S, D, F = cache.cross_k.shape[3], H * Dh, fw["b1"].shape[1]
    int8w = is_int8(fw)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sc = _step_scratch(x.device, stream, B, D, F, plan)
    out = torch.empty_like(x) if out is None else out
    scales = [fw[n] if int8w else None for n in _SCALES]
    ptrs = [x, out, pos, enc_mask, *(fw[n] for n in _GEMMS),
            *(fw[n] for n in _BIASES), *scales, *(fw[n] for n in _LNS),
            cache.self_k, cache.self_v, cache.cross_k, cache.cross_v,
            *(sc[n] for n in ("hbuf", "y", "a", "t", "mid", "part", "stats",
                              "counters", "bar")), *([trace] if trace is not None else [])]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(
        *(None if t is None else t.data_ptr() for t in ptrs))
    dims = (ctypes.c_int * 8)(Lyr, B, H, T, S, F, int(x.dtype == torch.bfloat16), bc)
    ints = plan_ints(plan)
    rc = fn(c_ptrs, dims, (ctypes.c_int * len(ints))(*ints),
            float(cfg.layer_norm_eps), plan["grid"], stream)
    build.check(rc, fn.__name__)
    return out


def _launch_cluster(fn, fw: PackedWeights, cfg, x, cache, pos, enc_mask, plan: dict,
                    trace: Optional[torch.Tensor] = None):
    """Call the cluster kernel's C entry point ``fn`` (of ``fw``'s weight
    mode) with ``plan`` (:func:`cluster_plan`) on arguments
    :func:`_check_step_args` has passed; returns the hidden state in x's
    dtype.  No scratch: the state lives in the clusters' shared memory.
    ``trace`` goes to a build with ``-DTTS_TRACE``
    (``ops/tts_step_ablate.py``)."""
    Lyr, B, H, T, Dh = cache.self_k.shape
    bc = cache.self_k.stride(0) // cache.self_k.stride(1)  # the caches' slots
    S, F = cache.cross_k.shape[3], fw["b1"].shape[1]
    int8w = is_int8(fw)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(x)
    scales = [fw[n] if int8w else None for n in _SCALES]
    ptrs = [x, out, pos, enc_mask, *(fw[n] for n in _GEMMS),
            *(fw[n] for n in _BIASES), *scales, *(fw[n] for n in _LNS),
            cache.self_k, cache.self_v, cache.cross_k, cache.cross_v,
            *([trace] if trace is not None else [])]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(
        *(None if t is None else t.data_ptr() for t in ptrs))
    dims = (ctypes.c_int * 8)(Lyr, B, H, T, S, F, int(x.dtype == torch.bfloat16), bc)
    ints = cluster_plan_ints(plan)
    rc = fn(c_ptrs, dims, (ctypes.c_int * len(ints))(*ints), float(cfg.layer_norm_eps),
            stream)
    build.check(rc, fn.__name__)
    return out


def run_groups(step_group, x, cache, pos, enc_mask=None):
    """Run ``step_group(x, cache, pos, enc_mask, out)`` once per group of at
    most ``MAX_B`` slots, in slot order; returns the ``[B, 1, D]`` hidden.

    Each call gets its slots' rows of x, pos and the mask (contiguous
    slices), the caches' slot slice (views that write through to the
    caches) and the slice of the output it must write.  Up to ``MAX_B``
    slots that is one call on the whole tensors."""
    B = x.shape[0]
    out = torch.empty_like(x)
    for b0 in range(0, B, MAX_B):
        sl = slice(b0, min(B, b0 + MAX_B))
        group = dataclasses.replace(
            cache, **{n: getattr(cache, n)[:, sl] for n in _CACHES})
        step_group(x[sl], group, pos[sl], None if enc_mask is None else enc_mask[sl],
                   out[sl])
    return out


def _check_device(fw: PackedWeights, x, cache, pos, enc_mask) -> torch.device:
    """The one CUDA device every tensor of the step lies on, or ValueError."""
    dev = x.device
    tensors = [x, pos, *(getattr(cache, n) for n in _CACHES)]
    if enc_mask is not None:
        tensors.append(enc_mask)
    if dev.type != "cuda" or any(t.device != dev for t in tensors) \
            or any(fw[n].device != dev for n in _GEMMS):
        raise ValueError("tts_step kernel: tensors must be on one CUDA device")
    return dev


def _kernel_decode_step(fw: PackedWeights, cfg, x, cache, pos, enc_mask=None):
    """The step kernel on every slot; same contract as
    :func:`_plain_decode_step`.  int8 codes go to ``tts_decode_step_int8``
    with their scales, bf16 weights to ``tts_decode_step``, each with the
    suffix ``_fp32`` over fp32 caches (:data:`_MODES`, in the library of
    :data:`_LIBRARIES`); anything else raises.  x is read as given and the
    hidden state comes back in x's dtype; pos is read as int64 and the bool
    mask as it is.  Over bf16 caches each launch is cooperative, one block
    per SM, and takes a group of at most ``MAX_B`` slots
    (:func:`run_groups`); over fp32 caches one launch of the cluster
    kernel takes every slot (:func:`cluster_plan`, which raises ValueError
    for a shape its shared memory cannot hold).  Each launch counts once."""
    Lyr, B, H, T, S, D, F = _check_step_args(fw, x, cache, pos, enc_mask)
    plan = (cluster_plan(B, D, F, Lyr, is_int8(fw)) if cache.self_k.dtype == torch.float32
            else None)  # a shape the cluster kernel cannot hold raises here
    dev = _check_device(fw, x, cache, pos, enc_mask)
    int8w = is_int8(fw)
    entry, counter = _MODES[(int8w, cache.self_k.dtype)]
    fn = getattr(build.load(_LIBRARIES[cache.self_k.dtype]), entry)
    if cache.self_k.dtype == torch.float32:  # one launch, a cluster per slot group
        out = _launch_cluster(fn, fw, cfg, x, cache, pos, enc_mask, plan)
        setattr(fused_decode_step, counter, getattr(fused_decode_step, counter) + 1)
        return out

    def launch_group(xg, group, pg, mg, out):
        _launch(fn, fw, cfg, xg, group, pg, mg,
                step_plan(xg.shape[0], D, F, int8w, _sm_count(dev)), out=out)
        setattr(fused_decode_step, counter, getattr(fused_decode_step, counter) + 1)

    return run_groups(launch_group, x, cache, pos, enc_mask)


def fused_decode_step(params, cfg, x, cache, pos, enc_mask=None, *,
                      packed: Optional[PackedWeights] = None):
    """One AR decoder step for all slots (drop-in for
    ``speecht5.decode_step``): x ``[B, 1, D]``, pos ``[B]``, canonical
    caches ``[L, B, H, T, Dh]`` (self K/V updated in place at ``pos``),
    enc_mask ``[B, S]`` bool or None.  Returns the ``[B, 1, D]`` hidden.

    On the card x must be fp32 or bf16, pos int64, enc_mask bool and the
    four caches all bf16 or all fp32, as the engine gives them, with T and
    S at most 4096 (and, over fp32 caches, a width :func:`cluster_plan`
    holds); anything else raises ValueError.  Over bf16 caches more than
    ``MAX_B`` slots take one launch per group of at most ``MAX_B``, over
    fp32 caches every step is one launch (:func:`launches_per_step`).  The CPU path is more lenient (any integer pos,
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


# kernel launches by mode, one per slot group of a step
fused_decode_step.launches = 0  # bf16 weights, bf16 caches
fused_decode_step.launches_int8 = 0  # int8 weights, bf16 caches
fused_decode_step.launches_fp32 = 0  # bf16 weights, fp32 caches
fused_decode_step.launches_int8_fp32 = 0  # int8 weights, fp32 caches
