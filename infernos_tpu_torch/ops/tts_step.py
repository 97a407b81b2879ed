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

    Big matrices ``[L, in, out]`` in ``dtype`` (default: the params' own),
    with 1/sqrt(Dh) folded into the self q third of ``wqkv`` and into the
    cross-q weights and biases; biases and LayerNorm parameters fp32.
    """
    dl = params["dec_layers"]
    sa, ca, ffn = dl["self_attn"], dl["cross_attn"], dl["ffn"]
    dtype = dtype or sa["q"]["w"].dtype
    D = sa["q"]["w"].shape[1]
    scale = (D // cfg.decoder_attention_heads) ** -0.5

    def w(t, s=1.0):
        return (t.float() * s).to(dtype).contiguous()

    def f(t, s=1.0):
        return (t.float() * s).contiguous()

    return {
        "wqkv": torch.cat([w(sa["q"]["w"], scale), w(sa["k"]["w"]),
                           w(sa["v"]["w"])], dim=2).contiguous(),
        "bqkv": torch.cat([f(sa["q"]["b"], scale), f(sa["k"]["b"]),
                           f(sa["v"]["b"])], dim=1).contiguous(),
        "wso": w(sa["o"]["w"]), "bso": f(sa["o"]["b"]),
        "wcq": w(ca["q"]["w"], scale), "bcq": f(ca["q"]["b"], scale),
        "wco": w(ca["o"]["w"]), "bco": f(ca["o"]["b"]),
        "w1": w(ffn["in"]["w"]), "b1": f(ffn["in"]["b"]),
        "w2": w(ffn["out"]["w"]), "b2": f(ffn["out"]["b"]),
        **{f"{n}{s}": f(dl[n][k]) for n in ("ln1", "ln2", "ln3")
           for s, k in (("g", "g"), ("b", "b"))},
    }


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
    in-place cache writes (in the cache's dtype, read back before use)."""
    B = x.shape[0]
    H = cfg.decoder_attention_heads
    eps = cfg.layer_norm_eps
    h = x[:, 0].float()
    D = h.shape[-1]
    Dh = D // H
    S = cache.cross_k.shape[3]
    madd = _mask_add(enc_mask, B, S, h.device)
    for l in range(fw["wqkv"].shape[0]):
        y = h @ fw["wqkv"][l].float() + fw["bqkv"][l]
        q, k, v = (y[:, i * D:(i + 1) * D].reshape(B, H, Dh) for i in range(3))
        wp = L.write_rows(cache.self_k[l], k, pos)
        L.write_rows(cache.self_v[l], v, pos)
        T = cache.self_k.shape[3]
        logits = torch.einsum("bhd,bhtd->bht", q, cache.self_k[l].float())
        valid = torch.arange(T, device=h.device)[None, :] <= wp[:, None]
        logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
        a = torch.einsum("bht,bhtd->bhd", torch.softmax(logits, -1),
                         cache.self_v[l].float()).reshape(B, D)
        h = _ln(h + a @ fw["wso"][l].float() + fw["bso"][l],
                fw["ln1g"][l], fw["ln1b"][l], eps)
        qc = (h @ fw["wcq"][l].float() + fw["bcq"][l]).reshape(B, H, Dh)
        logits = torch.einsum("bhd,bhsd->bhs", qc, cache.cross_k[l].float())
        if madd is not None:
            logits = logits + madd[:, None, :]
        a = torch.einsum("bhs,bhsd->bhd", torch.softmax(logits, -1),
                         cache.cross_v[l].float()).reshape(B, D)
        h = _ln(h + a @ fw["wco"][l].float() + fw["bco"][l],
                fw["ln2g"][l], fw["ln2b"][l], eps)
        f = L.gelu(h @ fw["w1"][l].float() + fw["b1"][l])
        h = _ln(h + f @ fw["w2"][l].float() + fw["b2"][l],
                fw["ln3g"][l], fw["ln3b"][l], eps)
    return h.to(x.dtype)[:, None, :]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WEIGHTS = ("wqkv", "bqkv", "wso", "bso", "wcq", "bcq", "wco", "bco",
            "w1", "b1", "w2", "b2", "ln1g", "ln1b", "ln2g", "ln2b", "ln3g", "ln3b")
_N_COUNTERS = 256  # split-K tile counters
MAX_T = 4096  # longest self or cross cache the attention kernel takes


def _kernel_decode_step(fw: PackedWeights, cfg, x, cache, pos, enc_mask=None):
    """Launch the kernel chain; same contract as :func:`_plain_decode_step`."""
    dev = x.device
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        t = getattr(cache, name)
        if t.device != dev or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"tts_step kernel: cache.{name} must be a "
                             f"contiguous bf16 tensor on {dev}")
    for name in _WEIGHTS:
        t = fw[name]
        want = torch.bfloat16 if name.startswith("w") else torch.float32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"tts_step kernel: packed {name} must be "
                             f"contiguous {want} on {dev}")
    Lyr, B, H, T, Dh = cache.self_k.shape
    S = cache.cross_k.shape[3]
    D = H * Dh
    F = fw["w1"].shape[2]
    if (Dh != 64 or x.shape != (B, 1, D) or D % 8 or F % 8 or D > 4096
            or T > MAX_T or S > MAX_T or cache.cross_k.shape != (Lyr, B, H, S, Dh)):
        raise ValueError("tts_step kernel: unsupported shape "
                         f"x {tuple(x.shape)}, cache {tuple(cache.self_k.shape)}")
    fn = build.load("tts_step").tts_decode_step
    fn.argtypes = [_P] * 30 + [_I, _P] + [_I] * 7 + [_F, _P]
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
            *(fw[n].data_ptr() for n in _WEIGHTS),
            cache.self_k.data_ptr(), cache.self_v.data_ptr(),
            cache.cross_k.data_ptr(), cache.cross_v.data_ptr(),
            y.data_ptr(), a.data_ptr(), t.data_ptr(), mid.data_ptr(),
            part.data_ptr(), part.numel(), counters.data_ptr(), _N_COUNTERS,
            Lyr, B, H, T, S, F, float(cfg.layer_norm_eps),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tts_decode_step")
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


fused_decode_step.launches = 0  # kernel-chain runs (one per step)
