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
the same bits) and to its refusals (33 slots, T 4097).
Tolerances: bf16 outputs of attention, 1e-2 absolute plus two bf16 steps
(2^-6) relative: the plain version computes in fp32 from the same bf16
inputs, and a short masked row's output is as large as a V entry; fp32
hidden state of the decoder step and its bf16 cache rows, 3e-2 (the kernel
rounds x to bf16 before each product, as the TPU kernel does); a bf16
hidden state, one more rounding (2^-7 relative).
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


def _step_setup(card, B, int8, T=16, S=8, seed=0):
    """Small-width decoder weights (random LN affine and biases) packed for
    the kernel, and caches of B slots."""
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
    init = [torch.randn((2, B, 2, t, 64), generator=g, device=card).to(torch.bfloat16)
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
@pytest.mark.parametrize("B", [1, 3, 8, 9, 32])
@pytest.mark.parametrize("pos_kind", sorted(POS_KINDS))
@pytest.mark.parametrize("mask_kind", ["null", "ragged"])
def test_decode_step_kernel_cases(card, mode, B, pos_kind, mask_kind):
    """One launch against the plain step: hidden and cache rows within 3e-2,
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
    assert after == ((before[0], before[1] + 1) if mode == "int8"
                     else (before[0] + 1, before[1]))
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
    B, T = (33, 16) if what == "B33" else (2, 4097)
    cfg, fw, init, g = _step_setup(card, B, False, T)
    x = torch.zeros((B, 1, 128), device=card)
    pos = torch.zeros(B, dtype=torch.long, device=card)
    with pytest.raises(ValueError, match="slots" if what == "B33" else "T 4097"):
        ts.fused_decode_step(None, cfg, x, _cache(init), pos, packed=fw)
