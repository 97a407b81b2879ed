"""SpeechT5 decoder step: the CUDA kernel chain and its plain PyTorch version.

``fused_decode_step`` replaces ``speecht5.decode_step`` in the TTS engine.
On CUDA tensors it runs ``csrc/tts_step.cu`` (the port of
``infernos_tpu/ops/tts_step.py::_layer_kernel``): every product and every
attention of the step is a hand-written kernel, 11 launches per layer, all
made by one C call per step.  On
CPU tensors it runs :func:`_plain_decode_step`, which repeats the same
arithmetic in fp32 PyTorch.  There is no fallback from the kernel to the
plain path.

Both update the self K/V caches in place at each slot's ``pos`` (no cache
copy) and return the new hidden state.  The step is memory-bound (weights
plus caches, see the source note in ``csrc/tts_step.cu``).  Weights are
packed once, at engine init, by :func:`pack_fused_weights`: packing inside
the step would re-read and re-write every weight each step.

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
from typing import Dict, Optional

import torch

from ..models import layers as L
from . import build

NEG_INF = -1e9
LAUNCHES_PER_LAYER = 11  # CUDA launches of the kernel chain per decoder layer

PackedWeights = Dict[str, torch.Tensor]


def pack_fused_weights(params, cfg, dtype: Optional[torch.dtype] = None
                       ) -> PackedWeights:
    """Decoder weights in the kernels' layouts (do this once).

    Dense tree: big matrices ``[L, in, out]`` in ``dtype`` (default: the
    params' own), with 1/sqrt(Dh) folded into the self q third of ``wqkv``
    and into the cross-q weights and biases; biases and LayerNorm parameters
    fp32.

    Quantized tree (``w_q`` in ``dec_layers.self_attn.q``): the same keys
    with the int8 codes untouched (``dtype`` does not apply to them), plus
    fp32 scales ``sqkv [L, 3D]``, ``sso``, ``scq``, ``sco``, ``s2 [L, D]``
    and ``s1 [L, F]``; 1/sqrt(Dh) is folded into the q third of ``sqkv``,
    into ``scq`` and into the q biases.
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
    return fw


def is_int8(fw: PackedWeights) -> bool:
    """Whether ``fw`` was packed from a quantized tree."""
    return fw["wqkv"].dtype == torch.int8


def _mask_add(enc_mask, B, S, device):
    if enc_mask is None:
        return None
    return torch.where(enc_mask.bool(), 0.0, NEG_INF).to(
        torch.float32).reshape(B, S).contiguous()


def _ln(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _plain_decode_step(fw: PackedWeights, cfg, x, cache, pos, enc_mask=None):
    """The kernels' arithmetic in fp32 PyTorch: same packed weights, same
    in-place cache writes (in the cache's dtype, read back before use).
    int8 mode: ``(h @ codes) * scale + bias``, the kernel's order."""
    B = x.shape[0]
    H = cfg.decoder_attention_heads
    eps = cfg.layer_norm_eps
    h = x[:, 0].float()
    D = h.shape[-1]
    Dh = D // H
    S = cache.cross_k.shape[3]
    madd = _mask_add(enc_mask, B, S, h.device)
    int8w = is_int8(fw)

    def mm(a, w, sc, b, l):
        y = a @ fw[w][l].float()
        if int8w:
            y = y * fw[sc][l]
        return y + fw[b][l]

    for l in range(fw["wqkv"].shape[0]):
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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WEIGHTS = ("wqkv", "bqkv", "wso", "bso", "wcq", "bcq", "wco", "bco",
            "w1", "b1", "w2", "b2", "ln1g", "ln1b", "ln2g", "ln2b", "ln3g", "ln3b")
_SCALES = ("sqkv", "sso", "scq", "sco", "s1", "s2")  # int8 mode only
_N_COUNTERS = 256  # split-K tile counters
MAX_T = 4096  # longest self or cross cache the attention kernel takes


def _kernel_decode_step(fw: PackedWeights, cfg, x, cache, pos, enc_mask=None):
    """Launch the kernel chain; same contract as :func:`_plain_decode_step`.
    int8 codes go to ``tts_decode_step_int8`` with their scales, bf16
    weights to ``tts_decode_step``; anything else raises."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("tts_step kernel: tensors must be on a CUDA device")
    int8w = is_int8(fw)
    wdt = torch.int8 if int8w else torch.bfloat16
    names = _WEIGHTS + (_SCALES if int8w else ())
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        t = getattr(cache, name)
        if t.device != dev or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"tts_step kernel: cache.{name} must be a "
                             f"contiguous bf16 tensor on {dev}")
    for name in names:
        t = fw[name]
        want = wdt if name.startswith("w") else torch.float32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"tts_step kernel: packed {name} must be "
                             f"contiguous {want} on {dev}")
    Lyr, B, H, T, Dh = cache.self_k.shape
    S = cache.cross_k.shape[3]
    D = H * Dh
    F = fw["w1"].shape[2]
    cols = 16 if int8w else 8  # output columns in one 16-byte load
    if (Dh != 64 or x.shape != (B, 1, D) or D % cols or F % cols or D > 4096
            or T > MAX_T or S > MAX_T or cache.cross_k.shape != (Lyr, B, H, S, Dh)):
        raise ValueError("tts_step kernel: unsupported shape "
                         f"x {tuple(x.shape)}, cache {tuple(cache.self_k.shape)}")
    lib = build.load("tts_step")
    fn = lib.tts_decode_step_int8 if int8w else lib.tts_decode_step
    fn.argtypes = [_P] * (len(names) + 12) + [_I, _P] + [_I] * 7 + [_F, _P]
    fn.restype = ctypes.c_int

    h = x[:, 0].to(torch.float32, copy=True).contiguous()  # the chain writes it
    pos32 = pos.to(device=dev, dtype=torch.int32).contiguous()
    madd = _mask_add(enc_mask, B, S, dev)
    sizes = (B * 3 * D, B * D, B * D, B * F, 24 * B * max(F, 3 * D))
    y, a, t, mid, part = torch.empty(sum(sizes), dtype=torch.float32,
                                     device=dev).split(sizes)  # one allocation
    counters = torch.empty(_N_COUNTERS, dtype=torch.int32, device=dev)
    rc = fn(h.data_ptr(), pos32.data_ptr(),
            None if madd is None else madd.data_ptr(),
            *(fw[n].data_ptr() for n in names),
            cache.self_k.data_ptr(), cache.self_v.data_ptr(),
            cache.cross_k.data_ptr(), cache.cross_v.data_ptr(),
            y.data_ptr(), a.data_ptr(), t.data_ptr(), mid.data_ptr(),
            part.data_ptr(), part.numel(), counters.data_ptr(), _N_COUNTERS,
            Lyr, B, H, T, S, F, float(cfg.layer_norm_eps),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tts_decode_step_int8" if int8w else "tts_decode_step")
    if int8w:
        fused_decode_step.launches_int8 += 1
    else:
        fused_decode_step.launches += 1
    return h.to(x.dtype)[:, None, :]


def fused_decode_step(params, cfg, x, cache, pos, enc_mask=None, *,
                      packed: Optional[PackedWeights] = None):
    """One AR decoder step for all slots (drop-in for
    ``speecht5.decode_step``): x ``[B, 1, D]``, pos ``[B]``, canonical
    caches ``[L, B, H, T, Dh]`` (self K/V updated in place at ``pos``),
    enc_mask ``[B, S]`` bool or None.  Returns the ``[B, 1, D]`` hidden.

    ``packed``: weights from :func:`pack_fused_weights` (pack once, outside
    any loop; without it the step packs on every call).
    """
    if x.device.type == "cuda":
        fw = packed if packed is not None else pack_fused_weights(
            params, cfg, torch.bfloat16)
        return _kernel_decode_step(fw, cfg, x, cache, pos, enc_mask)
    fw = packed if packed is not None else pack_fused_weights(params, cfg)
    return _plain_decode_step(fw, cfg, x, cache, pos, enc_mask)


fused_decode_step.launches = 0  # bf16 kernel-chain runs (one per step)
fused_decode_step.launches_int8 = 0  # int8 kernel-chain runs (one per step)
