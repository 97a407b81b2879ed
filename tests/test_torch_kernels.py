"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card (sm_90a) and ``nvcc``; without one they skip.
Run them there with ``python -m pytest -m cuda tests/test_torch_kernels.py``.
``chip_smoke.py`` holds the same kernels to their plain versions at the
main path's full widths; these cases add small and ragged shapes.
The attention kernel is also held to itself: the ``[B, S, H * 64]``
entry, heads read in place, must give the bits of the ``[BH, S, 64]`` one.
The decoder step (one cooperative launch per call, both weight modes) is
held at 1 to 32 slots, positions at 0, at T - 1 and past it, with and
without a ragged mask, to itself (two calls and a CUDA-graph replay give
the same bits) and to its refusal of T 4097; 33, 40 and 48 slots run as a
launch per group of 32 slots.  ``KernelAttention`` (the kernel's forward,
the reference's recomputed backward) is held to fp32 autograd of the plain
attention.  A tiny random STT
actor (head dim 12) started on the card fails with the attention kernel's
refusal.
The fp32 modes: the fp32 attention kernel is held to the plain version
within 1e-5 relative L2 (both full fp32; only the order of the sums
differs), its autograd Function to fp32 autograd of the plain attention,
and mixed dtypes are refused.  The decoder step over fp32 caches, with
bf16 and with int8 weights, is held to the plain step over the same fp32
caches within the bf16 caches' 3e-2: the weights and the kernel's rounding
of x to bf16 before each product are the same in both cache modes, and
only the cache rows are exact now.  That mode's kernel (one thread-block
cluster per group of at most 8 slots, ``csrc/tts_step_cluster.cu``) is
also held at the tiny-real engine's shape on its trained weights, at
SpeechT5's full width, at 40 and 48 slots (one launch), over chained
steps, and to itself under a CUDA-graph capture.
Tolerances: bf16 outputs of attention, 1e-2 absolute plus two bf16 steps
(2^-6) relative: the plain version computes in fp32 from the same bf16
inputs, and a short masked row's output is as large as a V entry; fp32
hidden state of the decoder step and its bf16 cache rows, 3e-2 (the kernel
rounds x to bf16 before each product, as the TPU kernel does); a bf16
hidden state, one more rounding (2^-7 relative).
The int8-direct cross-attention kernel (``csrc/cross_attention_i8.cu``) is
held to its plain version on the same CUDA tensors at S 1, 63 and 1500 and
at B * H of 1 and 320, unmasked and with per-slot lengths (some slots
empty), in bf16 and fp32: the weights' int8 codes (at most one in a
thousand one apart, the softmax summed in another order) and the output
within 2^-7 (bf16) or 1e-4 (fp32) relative L2; it refuses a
non-contiguous or wrong-type cache and a failed build raises.
"""

import pytest
import torch

from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.ops import attention as attn
from infernos_tpu_torch.ops import tts_step as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; this host has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("S", [1, 63, 64, 130, 1500])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_kernel_matches_plain(card, S, masked):
    g = torch.Generator(device=card).manual_seed(S)
    q, k, v = (torch.randn((6, S, 64), generator=g, device=card)
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.zeros((6, S), device=card)
    if masked:
        lens = torch.randint(1, S + 1, (6,), generator=g, device=card)
        mask = torch.where(torch.arange(S, device=card)[None] < lens[:, None],
                           0.0, attn.NEG_INF)
    before = attn.fused_attention.launches
    got = attn._kernel_attention(q, k, v, mask)
    want = attn._plain_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert attn.fused_attention.launches == before + 1
    # bf16 output: one rounding step apart is 2^-7 relative
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=2 ** -6)


def _plain_bsd(q, k, v, mask_add, H):
    """The plain version on ``[B, S, H * 64]`` with a ``[B, S]`` additive
    mask or None (the kernel's own contract)."""
    mask = None if mask_add is None else mask_add == 0
    return attn.by_heads(attn._plain_attention, q, k, v, n_heads=H, mask=mask)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 401, 1500])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mask_mode", ["null", "zeros", "lens"])
def test_attention_kernel_heads_in_place_matches_plain(card, S, B, mask_mode):
    """``[B, S, H * 64]`` projections read in place (thirds of one fused
    buffer, so the row stride is 3 * D), tile-edge S, a null mask pointer,
    an all-zero mask and per-batch key lengths.  The same data through the
    ``[BH, S, 64]`` entry must give identical bits: both are one kernel
    doing the same arithmetic on the same values, only addresses differ."""
    H = 4
    g = torch.Generator(device=card).manual_seed(1000 * B + S)
    qkv = torch.randn((B, S, 3 * H * 64), generator=g, device=card).to(torch.bfloat16)
    q, k, v = qkv.split(H * 64, dim=-1)
    mask_add = None
    if mask_mode == "zeros":
        mask_add = torch.zeros((B, S), device=card)
    elif mask_mode == "lens":
        lens = torch.randint(1, S + 1, (B,), generator=g, device=card)
        mask_add = torch.where(torch.arange(S, device=card)[None] < lens[:, None],
                               0.0, attn.NEG_INF)
    before = attn.fused_attention.launches
    got = attn._kernel_attention(q, k, v, mask_add, n_heads=H)
    torch.cuda.synchronize()
    assert attn.fused_attention.launches == before + 1
    assert got.shape == (B, S, H * 64) and got.is_contiguous()
    want = _plain_bsd(q, k, v, mask_add, H)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=2 ** -6)

    def split(x):
        return (x.reshape(B, S, H, 64).transpose(1, 2)
                .reshape(B * H, S, 64).contiguous())

    mask_bh = None if mask_add is None else mask_add.repeat_interleave(H, dim=0)
    by_bh = attn._kernel_attention(split(q), split(k), split(v), mask_bh)
    torch.cuda.synchronize()
    assert torch.equal(by_bh, split(got))


def test_fused_attention_on_card_is_one_launch(card):
    """The public entry on CUDA tensors: the kernel, once, nothing around it."""
    g = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn((2, 300, 1280), generator=g, device=card)
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.arange(300, device=card)[None] < torch.tensor([[300], [17]], device=card)
    for m in (None, mask):
        before = attn.fused_attention.launches
        got = attn.fused_attention(q, k, v, n_heads=20, mask=m)
        torch.cuda.synchronize()
        assert attn.fused_attention.launches == before + 1
        want = attn.by_heads(attn._plain_attention, q, k, v, n_heads=20, mask=m)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=2 ** -6)


def test_attention_kernel_refuses_other_head_dims(card):
    q = torch.zeros((2, 8, 32), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head dim"):
        attn._kernel_attention(q, q, q, torch.zeros((2, 8), device=card))


@pytest.mark.parametrize("B,pos", [(3, [0, 5, 15]), (9, [15] * 9)])
def test_decode_step_kernel_matches_plain(card, B, pos):
    cfg = st5.SpeechT5Config(hidden_size=128, decoder_layers=2,
                             decoder_attention_heads=2, encoder_attention_heads=2,
                             decoder_ffn_dim=256)
    g = torch.Generator(device=card).manual_seed(B)
    params = st5.init_params(cfg, g, card, torch.bfloat16)
    for n in ("ln1", "ln2", "ln3"):  # init is g=1, b=0: make the affine part count
        ln = params["dec_layers"][n]
        ln["g"] = 1 + 0.1 * torch.randn(ln["g"].shape, generator=g, device=card)
        ln["b"] = 0.1 * torch.randn(ln["b"].shape, generator=g, device=card)
    fw = ts.pack_fused_weights(params, cfg, torch.bfloat16)
    T, S = 16, 8
    init = [torch.randn((2, B, 2, t, 64), generator=g, device=card).to(torch.bfloat16)
            for t in (T, T, S, S)]
    ck = st5.DecoderCache(*(t.clone() for t in init))
    cp = st5.DecoderCache(*(t.clone() for t in init))
    enc_mask = torch.arange(S, device=card)[None] < torch.arange(1, B + 1, device=card)[:, None]
    p = torch.tensor(pos, device=card)
    x = torch.randn((B, 1, 128), generator=g, device=card)
    hk = ts._kernel_decode_step(fw, cfg, x, ck, p, enc_mask)
    hp = ts._plain_decode_step(fw, cfg, x, cp, p, enc_mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(hk, hp, atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_k.float(), cp.self_k.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_v.float(), cp.self_v.float(), atol=3e-2, rtol=0)
    changed = (ck.self_k != init[0]).any(dim=(0, 2, 4))  # [B, T]
    assert not changed[torch.arange(T, device=card)[None] != p[:, None]].any()


@pytest.mark.parametrize("B,pos", [(3, [0, 5, 15]), (9, [15] * 9), (5, [2, 0, 9, 15, 7])])
def test_decode_step_int8_kernel_matches_plain(card, B, pos):
    """int8 weight codes + per-output-channel fp32 scales through
    ``tts_decode_step_int8``: ragged B and pos, random LN scales and shifts,
    random (not init-time) biases so the scale-then-bias order counts."""
    from infernos_tpu_torch.models.quant import quantize_params

    cfg = st5.SpeechT5Config(hidden_size=128, decoder_layers=2,
                             decoder_attention_heads=2, encoder_attention_heads=2,
                             decoder_ffn_dim=256)
    g = torch.Generator(device=card).manual_seed(100 + B)
    params = st5.init_params(cfg, g, card, torch.bfloat16)
    dl = params["dec_layers"]
    for n in ("ln1", "ln2", "ln3"):
        dl[n]["g"] = 1 + 0.1 * torch.randn(dl[n]["g"].shape, generator=g, device=card)
        dl[n]["b"] = 0.1 * torch.randn(dl[n]["b"].shape, generator=g, device=card)
    for node in (*dl["self_attn"].values(), *dl["cross_attn"].values(),
                 *dl["ffn"].values()):
        node["b"] = 0.5 * torch.randn(node["b"].shape, generator=g, device=card)
    fw = ts.pack_fused_weights(quantize_params(params, min_size=0), cfg)
    assert ts.is_int8(fw) and fw["sqkv"].dtype == torch.float32
    T, S = 16, 8
    init = [torch.randn((2, B, 2, t, 64), generator=g, device=card).to(torch.bfloat16)
            for t in (T, T, S, S)]
    ck = st5.DecoderCache(*(t.clone() for t in init))
    cp = st5.DecoderCache(*(t.clone() for t in init))
    enc_mask = torch.arange(S, device=card)[None] < torch.arange(1, B + 1, device=card)[:, None].clamp(max=S)
    p = torch.tensor(pos, device=card)
    x = torch.randn((B, 1, 128), generator=g, device=card)
    before = (ts.fused_decode_step.launches, ts.fused_decode_step.launches_int8)
    hk = ts._kernel_decode_step(fw, cfg, x, ck, p, enc_mask)
    hp = ts._plain_decode_step(fw, cfg, x, cp, p, enc_mask)
    torch.cuda.synchronize()
    assert (ts.fused_decode_step.launches, ts.fused_decode_step.launches_int8) \
        == (before[0], before[1] + 1)
    torch.testing.assert_close(hk, hp, atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_k.float(), cp.self_k.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_v.float(), cp.self_v.float(), atol=3e-2, rtol=0)
    changed = (ck.self_k != init[0]).any(dim=(0, 2, 4))  # [B, T]
    assert not changed[torch.arange(T, device=card)[None] != p[:, None]].any()


def test_decode_step_kernel_refuses_mixed_weight_types(card):
    """int8 codes need fp32 scales and int8 everywhere; no quiet route."""
    from infernos_tpu_torch.models.quant import quantize_params

    cfg = st5.SpeechT5Config(hidden_size=128, decoder_layers=1,
                             decoder_attention_heads=2, encoder_attention_heads=2,
                             decoder_ffn_dim=256)
    g = torch.Generator(device=card).manual_seed(1)
    params = st5.init_params(cfg, g, card, torch.bfloat16)
    fw = ts.pack_fused_weights(quantize_params(params, min_size=0), cfg)
    cache = st5.init_cache(cfg, 2, 16, 8, card, dtype=torch.bfloat16)
    x = torch.zeros((2, 1, 128), device=card)
    pos = torch.zeros(2, dtype=torch.long, device=card)
    with pytest.raises(ValueError, match="w1"):
        ts._kernel_decode_step({**fw, "w1": fw["w1"].to(torch.bfloat16)}, cfg, x, cache, pos)
    with pytest.raises(ValueError, match="sso"):
        ts._kernel_decode_step({**fw, "sso": fw["sso"].to(torch.bfloat16)}, cfg, x, cache, pos)


def _step_setup(card, B, int8, T=16, S=8, seed=0, cdt=torch.bfloat16):
    """Small-width decoder weights (random LN affine and biases) packed for
    the kernel, and caches of B slots in ``cdt``."""
    from infernos_tpu_torch.models.quant import quantize_params

    cfg = st5.SpeechT5Config(hidden_size=128, decoder_layers=2,
                             decoder_attention_heads=2, encoder_attention_heads=2,
                             decoder_ffn_dim=256)
    g = torch.Generator(device=card).manual_seed(1000 * seed + B)
    params = st5.init_params(cfg, g, card, torch.bfloat16)
    dl = params["dec_layers"]
    for n in ("ln1", "ln2", "ln3"):
        dl[n]["g"] = 1 + 0.1 * torch.randn(dl[n]["g"].shape, generator=g, device=card)
        dl[n]["b"] = 0.1 * torch.randn(dl[n]["b"].shape, generator=g, device=card)
    for node in (*dl["self_attn"].values(), *dl["cross_attn"].values(),
                 *dl["ffn"].values()):
        node["b"] = 0.5 * torch.randn(node["b"].shape, generator=g, device=card)
    if int8:
        params = quantize_params(params, min_size=0)
    fw = ts.pack_fused_weights(params, cfg, torch.bfloat16)
    assert ts.is_int8(fw) == int8
    init = [torch.randn((2, B, 2, t, 64), generator=g, device=card).to(cdt)
            for t in (T, T, S, S)]
    return cfg, fw, init, g


def _cache(init):
    return st5.DecoderCache(*(t.clone() for t in init))


POS_KINDS = {
    "zero": lambda B, T: [0] * B,
    "last": lambda B, T: [T - 1] * B,
    "past": lambda B, T: [T - 1 + i % 3 for i in range(B)],  # clamped to T - 1
    "ragged": lambda B, T: [(5 * i + 2) % T for i in range(B)],
}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 32, 40])
@pytest.mark.parametrize("pos_kind", sorted(POS_KINDS))
@pytest.mark.parametrize("mask_kind", ["null", "ragged"])
def test_decode_step_kernel_cases(card, mode, B, pos_kind, mask_kind):
    """One launch (two at 40 slots) against the plain step: hidden and cache rows within 3e-2,
    rows other than pos untouched, the output in x's dtype (bf16 x with no
    mask, fp32 x with a ragged mask)."""
    T, S = 16, 8
    cfg, fw, init, g = _step_setup(card, B, mode == "int8", T, S)
    ck, cp = _cache(init), _cache(init)
    pos = torch.tensor(POS_KINDS[pos_kind](B, T), device=card)
    enc_mask = None
    if mask_kind == "ragged":
        lens = torch.arange(B, device=card) % S + 1
        enc_mask = torch.arange(S, device=card)[None] < lens[:, None]
    xdt = torch.bfloat16 if mask_kind == "null" else torch.float32
    x = torch.randn((B, 1, 128), generator=g, device=card).to(xdt)
    before = (ts.fused_decode_step.launches, ts.fused_decode_step.launches_int8)
    hk = ts.fused_decode_step(None, cfg, x, ck, pos, enc_mask, packed=fw)
    hp = ts._plain_decode_step(fw, cfg, x, cp, pos, enc_mask)
    torch.cuda.synchronize()
    after = (ts.fused_decode_step.launches, ts.fused_decode_step.launches_int8)
    n = ts.launches_per_step(B)
    assert after == ((before[0], before[1] + n) if mode == "int8"
                     else (before[0] + n, before[1]))
    assert hk.dtype == xdt and hk.shape == (B, 1, 128)
    # a bf16 output is one rounding of the same fp32 value
    tol = dict(atol=3e-2, rtol=2 ** -7 if xdt == torch.bfloat16 else 0)
    torch.testing.assert_close(hk.float(), hp.float(), **tol)
    torch.testing.assert_close(ck.self_k.float(), cp.self_k.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_v.float(), cp.self_v.float(), atol=3e-2, rtol=0)
    wp = pos.clamp(max=T - 1)
    changed = (ck.self_k != init[0]).any(dim=(0, 2, 4)) | \
        (ck.self_v != init[1]).any(dim=(0, 2, 4))  # [B, T]
    assert not changed[torch.arange(T, device=card)[None] != wp[:, None]].any()
    assert torch.equal(ck.cross_k, init[2]) and torch.equal(ck.cross_v, init[3])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("B", [3, 32])
def test_decode_step_kernel_with_the_smallest_items_plan(card, mode, B):
    """At this width the default plan takes one K split a product up to 16
    slots; the plan of the smallest items (the default beyond) splits every
    product, so the last blocks' split sums run: same checks against the
    plain step."""
    from infernos_tpu_torch.ops import build

    T, S = 16, 8
    cfg, fw, init, g = _step_setup(card, B, mode == "int8", T, S, seed=2)
    plan = ts.step_plan(B, 128, 256, mode == "int8", ts._sm_count(torch.device(card)),
                        max_tiles=None)
    assert all(gm["splits"] > 1 for gm in plan["gemms"])
    ck, cp = _cache(init), _cache(init)
    pos = torch.tensor(POS_KINDS["ragged"](B, T), device=card)
    enc_mask = torch.arange(S, device=card)[None] < (torch.arange(B, device=card) % S + 1)[:, None]
    x = torch.randn((B, 1, 128), generator=g, device=card)
    lib = build.load("tts_step")
    fn = lib.tts_decode_step_int8 if mode == "int8" else lib.tts_decode_step
    hk = ts._launch(fn, fw, cfg, x, ck, pos, enc_mask, plan)
    hp = ts._plain_decode_step(fw, cfg, x, cp, pos, enc_mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(hk, hp, atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_k.float(), cp.self_k.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_v.float(), cp.self_v.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_decode_step_kernel_is_deterministic_and_graph_replays_it(card, mode):
    """Two eager calls on the same inputs give the same bits (split-K sums in
    a fixed order, no atomics on values), and so does the call captured in a
    CUDA graph and replayed."""
    B, T = 8, 16
    cfg, fw, init, g = _step_setup(card, B, mode == "int8", T, seed=1)
    pos = torch.tensor(POS_KINDS["ragged"](B, T), device=card)
    enc_mask = torch.arange(8, device=card)[None] < (torch.arange(B, device=card) % 8 + 1)[:, None]
    x = torch.randn((B, 1, 128), generator=g, device=card).to(torch.bfloat16)
    step = lambda c: ts.fused_decode_step(None, cfg, x, c, pos, enc_mask, packed=fw)
    c1, c2, c3 = _cache(init), _cache(init), _cache(init)
    h1, h2 = step(c1), step(c2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h3 = step(c3)
    graph.replay()
    torch.cuda.synchronize()
    for h in (h2, h3):
        assert torch.equal(h, h1)
    for c in (c2, c3):
        assert torch.equal(c.self_k, c1.self_k) and torch.equal(c.self_v, c1.self_v)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_decode_step_kernel_keeps_scratch_per_stream(card, mode):
    """Steps of one plan on two streams get a barrier and buffers each, and
    both give the bits of the step on the default stream."""
    B, T = 8, 16
    cfg, fw, init, g = _step_setup(card, B, mode == "int8", T, seed=3)
    pos = torch.tensor(POS_KINDS["ragged"](B, T), device=card)
    x = torch.randn((B, 1, 128), generator=g, device=card).to(torch.bfloat16)
    step = lambda c: ts.fused_decode_step(None, cfg, x, c, pos, packed=fw)
    ref = step(_cache(init))
    torch.cuda.synchronize()
    bars = set()
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            h = step(_cache(init))
        stream.synchronize()
        assert torch.equal(h, ref)
        bars |= {sc["bar"].data_ptr() for key, sc in ts._scratch.items()
                 if key[1:5] == (stream.cuda_stream, B, 128, 256)}
    assert len(bars) == 2


@pytest.mark.parametrize("what", ["B33", "T4097"])
def test_decode_step_kernel_refuses_too_many_slots_or_rows(card, what):
    """T 4097 is refused; 33 slots, refused before slot groups, are taken in
    two launches and match the plain step."""
    B, T = (33, 16) if what == "B33" else (2, 4097)
    cfg, fw, init, g = _step_setup(card, B, False, T)
    x = torch.zeros((B, 1, 128), device=card)
    pos = torch.zeros(B, dtype=torch.long, device=card)
    if what == "B33":
        ck, cp = _cache(init), _cache(init)
        hk = ts.fused_decode_step(None, cfg, x, ck, pos, packed=fw)
        hp = ts._plain_decode_step(fw, cfg, x, cp, pos)
        torch.testing.assert_close(hk, hp, atol=3e-2, rtol=0)
        return
    with pytest.raises(ValueError, match="T 4097"):
        ts.fused_decode_step(None, cfg, x, _cache(init), pos, packed=fw)


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_attention_gradients_match_fp32_autograd_of_plain(card, masked):
    """``fused_attention`` under grad on the card: one launch, an autograd
    node, and dq/dk/dv within 4e-3 relative L2 of fp32 autograd through the
    plain attention on the same bf16 inputs (each gradient rounded to bf16)."""
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn((2, 130, 256), generator=g, device=card)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    gout = torch.randn((2, 130, 256), generator=g, device=card).to(torch.bfloat16)
    mask = torch.arange(130, device=card)[None] < torch.tensor([[130], [77]], device=card) \
        if masked else None
    before = attn.fused_attention.launches
    out = attn.fused_attention(q, k, v, n_heads=4, mask=mask)
    assert attn.fused_attention.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), gout)
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = attn.by_heads(attn._plain_attention, *ref_in, n_heads=4, mask=mask)
    want = torch.autograd.grad(ref, ref_in, gout.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert ((a.float() - b).norm() / b.norm()).item() <= 4e-3


def test_tiny_random_stt_actor_on_the_card_fails_with_the_kernel_error(card, monkeypatch):
    """The tiny random dims have head dim 12, which the attention kernel
    does not take: on the card the actor's start raises the kernel's
    refusal, with no fallback to the plain version."""
    from infernos_tpu_torch.cluster.model_actors import STTActor

    monkeypatch.delenv("INFERNOS_MODEL_MODE", raising=False)
    actor = STTActor(tiny=True, device=card)
    with pytest.raises(ValueError, match="head"):
        actor.start()
    assert actor.driver is None


def _rel_l2(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


@pytest.mark.parametrize("S", [1, 63, 64, 65, 100, 129, 250, 450, 600, 1500])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["bh", "bsd"])
@pytest.mark.parametrize("BH", [6, 1, 4, 8, 32])
def test_attention_fp32_kernel_matches_plain(card, S, masked, layout, BH):
    """The fp32 mode against the plain version in fp32: ``[BH, S, 64]`` and
    ``[B, S, H * 64]`` thirds of one projection read in place (4 heads,
    ``B = BH / 4``, 2 for BH 6), tile-edge S, head counts and lengths that
    reach every branch of ``fp32_plan`` (no split, clusters of 2, 4 and 8,
    each block shape; the tiny-real ``[4|8, 100|250]`` and the
    trainer's ``[32, 250]``), per-row key lengths with the first row's last
    64-key tile masked whole; one fp32 launch, the bf16 count untouched; a
    CUDA-graph replay gives the eager call's bits."""
    g = torch.Generator(device=card).manual_seed(7000 + S + 31 * BH)
    if layout == "bh":
        H, q, k, v = 1, *(torch.randn((BH, S, 64), generator=g, device=card)
                          for _ in range(3))
    else:
        H, B = 4, 2 if BH == 6 else max(1, BH // 4)
        q, k, v = torch.randn((B, S, 3 * H * 64), generator=g, device=card).split(H * 64, -1)
    B = q.shape[0]
    mask_add = None
    if masked:
        lens = torch.randint(1, S + 1, (B,), generator=g, device=card)
        lens[0] = max(1, (S - 1) // 64 * 64 - 1)  # no key of the last tile
        mask_add = torch.where(torch.arange(S, device=card)[None] < lens[:, None],
                               0.0, attn.NEG_INF)
    before = (attn.fused_attention.launches, attn.fused_attention.launches_fp32)
    got = attn._kernel_attention(q, k, v, mask_add, n_heads=H)
    torch.cuda.synchronize()
    assert (attn.fused_attention.launches, attn.fused_attention.launches_fp32) == \
        (before[0], before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (B, S, H * 64)
    want = _plain_bsd(q, k, v, mask_add, H)
    assert _rel_l2(got, want) <= 1e-5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = attn._kernel_attention(q, k, v, mask_add, n_heads=H)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)


def test_attention_kernel_refuses_mixed_dtypes_on_the_card(card):
    q = torch.zeros((2, 8, 64), device=card)
    with pytest.raises(ValueError, match="share one dtype"):
        attn._kernel_attention(q, q.to(torch.bfloat16), q, None)
    with pytest.raises(ValueError, match="share one dtype"):
        attn.fused_attention(q, q, q.to(torch.bfloat16), n_heads=1)


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_attention_fp32_gradients_match_fp32_autograd_of_plain(card, masked):
    """``fused_attention`` under grad on fp32 inputs, as a trainer calls it:
    one fp32 launch, and dq/dk/dv within 1e-5 relative L2 of fp32 autograd
    through the plain attention (the backward is that recompute; only the
    forward's kernel differs)."""
    g = torch.Generator(device=card).manual_seed(6)
    q, k, v = (torch.randn((2, 130, 256), generator=g, device=card).requires_grad_()
               for _ in range(3))
    gout = torch.randn((2, 130, 256), generator=g, device=card)
    mask = torch.arange(130, device=card)[None] < torch.tensor([[130], [77]], device=card) \
        if masked else None
    before = attn.fused_attention.launches_fp32
    out = attn.fused_attention(q, k, v, n_heads=4, mask=mask)
    assert attn.fused_attention.launches_fp32 == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), gout)
    ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = attn.by_heads(attn._plain_attention, *ref_in, n_heads=4, mask=mask)
    want = torch.autograd.grad(ref, ref_in, gout)
    assert _rel_l2(out.detach(), ref.detach()) <= 1e-5
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and _rel_l2(a, b) <= 1e-5


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 3, 9, 32, 40])
@pytest.mark.parametrize("pos_kind", sorted(POS_KINDS))
@pytest.mark.parametrize("mask_kind", ["null", "ragged"])
def test_decode_step_fp32_caches_kernel_cases(card, mode, B, pos_kind, mask_kind):
    """The fp32-cache modes (bf16 or int8 weights over fp32 caches): one
    launch of the cluster kernel at any slot count, counted in its own mode,
    against the plain step over the same fp32 caches; rows other than pos
    and the cross caches untouched, bit for bit."""
    T, S = 16, 8
    cfg, fw, init, g = _step_setup(card, B, mode == "int8", T, S, seed=4, cdt=torch.float32)
    ck, cp = _cache(init), _cache(init)
    pos = torch.tensor(POS_KINDS[pos_kind](B, T), device=card)
    enc_mask = None
    if mask_kind == "ragged":
        lens = torch.arange(B, device=card) % S + 1
        enc_mask = torch.arange(S, device=card)[None] < lens[:, None]
    x = torch.randn((B, 1, 128), generator=g, device=card)
    counters = ("launches", "launches_int8", "launches_fp32", "launches_int8_fp32")
    before = [getattr(ts.fused_decode_step, c) for c in counters]
    hk = ts.fused_decode_step(None, cfg, x, ck, pos, enc_mask, packed=fw)
    hp = ts._plain_decode_step(fw, cfg, x, cp, pos, enc_mask)
    torch.cuda.synchronize()
    moved = [getattr(ts.fused_decode_step, c) - b for c, b in zip(counters, before)]
    n = ts.launches_per_step(B, fp32_caches=True)
    assert moved == ([0, 0, 0, n] if mode == "int8" else [0, 0, n, 0])
    assert hk.dtype == torch.float32 and ck.self_k.dtype == torch.float32
    torch.testing.assert_close(hk, hp, atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_k, cp.self_k, atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_v, cp.self_v, atol=3e-2, rtol=0)
    wp = pos.clamp(max=T - 1)
    changed = (ck.self_k != init[0]).any(dim=(0, 2, 4)) | \
        (ck.self_v != init[1]).any(dim=(0, 2, 4))  # [B, T]
    assert not changed[torch.arange(T, device=card)[None] != wp[:, None]].any()
    assert torch.equal(ck.cross_k, init[2]) and torch.equal(ck.cross_v, init[3])


def test_decode_step_kernel_refuses_mixed_cache_dtypes(card):
    cfg, fw, init, g = _step_setup(card, 2, False, cdt=torch.float32)
    cache = st5.DecoderCache(init[0], init[1].to(torch.bfloat16), init[2], init[3])
    x = torch.zeros((2, 1, 128), device=card)
    pos = torch.zeros(2, dtype=torch.long, device=card)
    with pytest.raises(ValueError, match="share one dtype"):
        ts.fused_decode_step(None, cfg, x, cache, pos, packed=fw)


STEP_COUNTERS = ("launches", "launches_int8", "launches_fp32", "launches_int8_fp32")


def _chained_fp32_steps(card, cfg, fw, g, B, T, S, pos0, lens, steps):
    """``steps`` chained steps of the cluster kernel and of the plain step
    from the same random fp32 caches (pos advancing, caches carried over),
    x fp32 on even steps and bf16 on odd ones: the hidden state within 3e-2
    (and one bf16 rounding for bf16 x), the rows written within 3e-2, every
    other row and the cross caches untouched, one launch a step in the
    mode's own counter."""
    Lyr, H = cfg.decoder_layers, cfg.decoder_attention_heads
    init = [torch.randn((Lyr, B, H, t, 64), generator=g, device=card) for t in (T, T, S, S)]
    ck, cp = _cache(init), _cache(init)
    enc_mask = torch.arange(S, device=card)[None] < torch.tensor(lens, device=card)[:, None]
    counter = "launches_int8_fp32" if ts.is_int8(fw) else "launches_fp32"
    written = torch.zeros((B, T), dtype=torch.bool, device=card)
    for it in range(steps):
        pos = torch.tensor(pos0, device=card) + it
        x = torch.randn((B, 1, cfg.hidden_size), generator=g, device=card)
        x = x if it % 2 == 0 else x.to(torch.bfloat16)
        before = [getattr(ts.fused_decode_step, c) for c in STEP_COUNTERS]
        hk = ts.fused_decode_step(None, cfg, x, ck, pos, enc_mask, packed=fw)
        hp = ts._plain_decode_step(fw, cfg, x, cp, pos, enc_mask)
        torch.cuda.synchronize()
        moved = {c: getattr(ts.fused_decode_step, c) - b
                 for c, b in zip(STEP_COUNTERS, before)}
        assert moved == {c: int(c == counter) for c in STEP_COUNTERS}
        assert hk.dtype == x.dtype and hk.shape == (B, 1, cfg.hidden_size)
        rtol = 2 ** -7 if x.dtype == torch.bfloat16 else 0
        torch.testing.assert_close(hk.float(), hp.float(), atol=3e-2, rtol=rtol)
        written[torch.arange(B, device=card), pos.clamp(max=T - 1)] = True
    torch.testing.assert_close(ck.self_k, cp.self_k, atol=3e-2, rtol=0)
    torch.testing.assert_close(ck.self_v, cp.self_v, atol=3e-2, rtol=0)
    for i, n in enumerate(("self_k", "self_v")):
        assert torch.equal(getattr(ck, n).permute(1, 3, 0, 2, 4)[~written],
                           init[i].permute(1, 3, 0, 2, 4)[~written])
    assert torch.equal(ck.cross_k, init[2]) and torch.equal(ck.cross_v, init[3])


def _tiny_real_fw(card, mode):
    from infernos_tpu_torch.models import tiny_real
    from infernos_tpu_torch.models.quant import quantize_params

    params, cfg = tiny_real.load_tiny_tts("gl", card)[:2]
    fw = ts.pack_fused_weights(quantize_params(params) if mode == "int8" else params, cfg)
    assert ts.is_int8(fw) == (mode == "int8")
    return cfg, fw


TINY_POS0 = [0, 169, 1, 80, 100, 37, 150, 7]  # chip_smoke.tiny_real_steps' positions
TINY_LENS = [48, 1, 20, 48, 7, 33, 48, 12]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_cluster_step_at_the_tiny_real_shape_on_its_weights(card, mode):
    """The tiny-real TTS engine's step (8 slots, T 170, S 48, D 256, 4
    heads, F 768, 3 layers) on the trained weights, four chained steps."""
    cfg, fw = _tiny_real_fw(card, mode)
    g = torch.Generator(device=card).manual_seed(11)
    _chained_fp32_steps(card, cfg, fw, g, 8, 170, 48, TINY_POS0, TINY_LENS, 4)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_cluster_step_at_full_width(card, mode):
    """SpeechT5's full width (D 768, 12 heads, F 3072, 6 layers), 8 slots,
    T 512, S 96, random weights with the LayerNorms' affine part drawn:
    two chained steps."""
    from infernos_tpu_torch.models.quant import quantize_params

    cfg = st5.SpeechT5Config()
    g = torch.Generator(device=card).manual_seed(12)
    params = st5.init_params(cfg, g, card, torch.bfloat16)
    for n in ("ln1", "ln2", "ln3"):
        ln = params["dec_layers"][n]
        ln["g"] = 1 + 0.1 * torch.randn(ln["g"].shape, generator=g, device=card)
        ln["b"] = 0.1 * torch.randn(ln["b"].shape, generator=g, device=card)
    fw = ts.pack_fused_weights(quantize_params(params) if mode == "int8" else params, cfg)
    _chained_fp32_steps(card, cfg, fw, g, 8, 512, 96, [0, 511, 1, 255, 100, 37, 400, 7],
                        [96, 1, 50, 96, 17, 80, 96, 33], 2)


@pytest.mark.parametrize("B", [40, 48])
def test_cluster_step_at_40_and_48_slots(card, B):
    """Five and six clusters of one launch, at the tiny-real shape."""
    cfg, fw = _tiny_real_fw(card, "bf16")
    g = torch.Generator(device=card).manual_seed(13 + B)
    pos0 = [0, 169] + [(37 * i) % 168 for i in range(B - 2)]
    lens = [48, 1] + [(7 * i) % 48 + 1 for i in range(B - 2)]
    _chained_fp32_steps(card, cfg, fw, g, B, 170, 48, pos0, lens, 2)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_cluster_step_is_deterministic_and_graph_replays_it(card, mode):
    """Two eager calls give the same bits, and so does the call captured in
    a CUDA graph and replayed (a cluster launch captures as a launch)."""
    cfg, fw = _tiny_real_fw(card, mode)
    g = torch.Generator(device=card).manual_seed(14)
    B, T, S = 8, 170, 48
    init = [torch.randn((3, B, 4, t, 64), generator=g, device=card) for t in (T, T, S, S)]
    pos = torch.tensor(TINY_POS0, device=card)
    enc_mask = torch.arange(S, device=card)[None] < torch.tensor(TINY_LENS, device=card)[:, None]
    x = torch.randn((B, 1, 256), generator=g, device=card)
    step = lambda c: ts.fused_decode_step(None, cfg, x, c, pos, enc_mask, packed=fw)
    c1, c2, c3 = _cache(init), _cache(init), _cache(init)
    h1, h2 = step(c1), step(c2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        h3 = step(c3)
    graph.replay()
    torch.cuda.synchronize()
    for h in (h2, h3):
        assert torch.equal(h, h1)
    for c in (c2, c3):
        assert torch.equal(c.self_k, c1.self_k) and torch.equal(c.self_v, c1.self_v)


# -- the int8-direct cross-attention kernel (csrc/cross_attention_i8.cu) -------

CROSS_I8_REL_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-4}


def _cross_i8_case(card, B, H, S, dtype, masked, seed):
    """``chip_smoke.cross_i8_case``: q scaled as the decode step scales it,
    int8 caches of positions of unlike magnitude, per-slot lengths with
    every fourth slot empty (a lone slot keeps half its positions), or the
    STT engine's lengths cycled over the slots (``"engine"``)."""
    import chip_smoke

    g = torch.Generator(device=card).manual_seed(seed)
    if masked == "engine":
        masked = chip_smoke.XI8_ENGINE_LENS
    return chip_smoke.cross_i8_case(torch, g, B, H, S, dtype, masked)


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 63, 1500])
@pytest.mark.parametrize("BH", [(1, 1), (16, 20)])
@pytest.mark.parametrize("masked", [False, True, "engine"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cross_i8_kernel_matches_plain(card, S, BH, masked, dtype, cluster):
    """The kernel against its plain version on the same CUDA tensors, under
    the wrapper's plan and under clusters of 1, 2, 4 and 8 blocks (at S 1
    and 63 some blocks own nothing or only masked positions; the engine's
    masks leave whole ranges and whole rows masked): the weights' codes
    equal but for at most one in a thousand (at least one allowed), each
    at most one apart (the softmax sums in another order); the output
    within one bf16 step (2^-7) or 1e-4 in fp32, relative L2; one launch;
    two calls and a CUDA-graph replay give the same bits."""
    from infernos_tpu_torch.ops import cross_attention_i8 as xi8

    B, H = BH
    q, kc, vc, mask = _cross_i8_case(card, B, H, S, dtype, masked,
                                     seed=S + 7 * B + (masked is True) + 2 * (cluster or 0))
    plan = None if cluster is None else xi8.cross_i8_plan(B * H, S, cluster=cluster)
    codes = torch.empty((B, H, S), dtype=torch.int8, device=card)
    before = xi8.cross_attention_i8.launches
    got = xi8._kernel_cross_attention_i8(q, kc, vc, mask, codes=codes, plan=plan)
    torch.cuda.synchronize()
    assert xi8.cross_attention_i8.launches == before + 1
    want, _, want_codes = xi8._plain_cross_attention_i8(q, kc, vc, mask, return_codes=True)
    assert got.dtype == dtype and got.shape == (B, H, 1, 64)
    assert torch.isfinite(got.float()).all()
    diff = (codes.int() - want_codes.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= max(1, codes.numel() // 1000)
    assert _rel_l2(got, want) <= CROSS_I8_REL_TOL[dtype]
    call = lambda: xi8._kernel_cross_attention_i8(q, kc, vc, mask, plan=plan)  # noqa: E731
    assert torch.equal(call(), got)
    if cluster is None:
        assert torch.equal(xi8.cross_attention_i8(q, kc, vc, mask), got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)


@pytest.mark.parametrize("BHS", [(24, 22, 14000), (16, 20, 30000)])
def test_cross_i8_kernel_at_plans_stepped_for_shared_memory(card, BHS):
    """Rows too long for the resident plan's shared memory (blocks of 64
    threads at 528 rows of 14,000; clusters of 4 at 320 rows of 30,000):
    the kernel under the wrapper's plan against its plain version, with
    the tolerances above."""
    from infernos_tpu_torch.ops import cross_attention_i8 as xi8

    B, H, S = BHS
    plan = xi8.cross_i8_plan(B * H, S)
    assert (plan["cluster"], plan["threads"]) in ((1, 64), (4, 128))
    q, kc, vc, mask = _cross_i8_case(card, B, H, S, torch.bfloat16, False, seed=S)
    codes = torch.empty((B, H, S), dtype=torch.int8, device=card)
    got = xi8._kernel_cross_attention_i8(q, kc, vc, mask, codes=codes)
    want, _, want_codes = xi8._plain_cross_attention_i8(q, kc, vc, mask, return_codes=True)
    diff = (codes.int() - want_codes.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= max(1, codes.numel() // 1000)
    assert _rel_l2(got, want) <= CROSS_I8_REL_TOL[torch.bfloat16]


def test_cross_i8_kernel_refuses_instead_of_taking_the_plain_route(card, monkeypatch):
    """A non-contiguous or wrong-type cache raises on the card, and so does
    a failed build: nothing reaches the plain version."""
    from infernos_tpu_torch.ops import build
    from infernos_tpu_torch.ops import cross_attention_i8 as xi8

    q, kc, vc, _ = _cross_i8_case(card, 2, 3, 40, torch.bfloat16, False, seed=1)
    strided = {"q": kc["q"].transpose(2, 3).contiguous().transpose(2, 3), "s": kc["s"]}
    with pytest.raises(ValueError, match="contiguous"):
        xi8.cross_attention_i8(q, strided, vc)
    with pytest.raises(ValueError, match="int8 codes and fp32 scales"):
        xi8.cross_attention_i8(q, {**kc, "s": kc["s"].half()}, vc)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        xi8.cross_attention_i8(q.half(), kc, vc)
    called = []
    monkeypatch.setattr(xi8, "_plain_cross_attention_i8", lambda *a, **k: called.append(a))

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    xi8._entry.cache_clear()
    monkeypatch.setattr(build, "load", no_build)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            xi8.cross_attention_i8(q, kc, vc)
    finally:
        xi8._entry.cache_clear()
    assert called == []
