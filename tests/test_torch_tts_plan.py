"""The decoder-step kernel's packed weights and launch plan, on the CPU.

The kernel (``csrc/tts_step.cu``) runs only on the card; what surrounds it
is Python and is held here: the panel layout of the weights
(``pack_panels``) round-trips exactly to ``[L, K, N]`` and follows the A
fragment order of ``mma.sync.m16n8k16``; the plain step reads panels
through the inverse and gives the same bits as from rows (and agrees with
the JAX reference as the rows do); the launch plan of every product covers
each output column and each K row exactly once with at most one item per
block and fits in a block's shared memory at full width for 1 to 32 slots;
and the wrapper refuses shapes and dtypes the kernel does not take before
it looks at the device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from infernos_tpu.models import speecht5 as jst5
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.models.quant import quantize_params
from infernos_tpu_torch.ops import tts_step as ts

FULL = dict(D=768, F=3072, grid=132)  # SpeechT5 width on an H100's 132 SMs


def _panelled(fw):
    """A CPU-packed tree with the big matrices in the card's panel layout."""
    return {**fw, **{n: ts.pack_panels(fw[n]) for n in ts._GEMMS}}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("shape", [(6, 768, 2304), (6, 3072, 768), (2, 64, 96), (1, 16, 16)])
def test_panels_round_trip_exactly(dtype, shape):
    g = torch.Generator().manual_seed(sum(shape))
    w = torch.randn(shape, generator=g)
    w = (w * 40).round().clamp(-127, 127).to(dtype) if dtype == torch.int8 else w.to(dtype)
    p = ts.pack_panels(w)
    L, K, N = shape
    assert p.shape == (L, N // 16, K // 16, 256) and p.dtype == dtype and p.is_contiguous()
    assert torch.equal(ts.unpack_panels(p), w)


def test_fragment_order_is_the_mma_a_layout():
    """Lane (g, t) holds, in order, A[g][2t..2t+1], A[g+8][2t..2t+1],
    A[g][2t+8..2t+9], A[g+8][2t+8..2t+9] of each 16 x 16 tile (A[m][k] =
    W[k][m]: the weight tile with output columns as rows)."""
    order = ts._frag_order()
    assert sorted(order.tolist()) == list(range(256))
    w = torch.arange(16 * 16, dtype=torch.float32).reshape(1, 16, 16)  # W[k][n] = 16k + n
    tile = ts.pack_panels(w)[0, 0, 0]
    for lane in (0, 5, 17, 31):
        g, t = divmod(lane, 4)
        want = [(k, m) for m, k in ((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1),
                                    (g, 2 * t + 8), (g, 2 * t + 9), (g + 8, 2 * t + 8),
                                    (g + 8, 2 * t + 9))]
        assert tile[lane * 8:lane * 8 + 8].tolist() == [16.0 * k + m for k, m in want]


def _small_cfg():
    return st5.SpeechT5Config(hidden_size=128, decoder_layers=2, encoder_layers=1,
                              decoder_attention_heads=2, encoder_attention_heads=2,
                              decoder_ffn_dim=256, encoder_ffn_dim=256)


@pytest.mark.parametrize("int8", [False, True])
def test_packed_tree_panels_match_rows(int8):
    cfg = _small_cfg()
    params = st5.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    if int8:
        params = quantize_params(params, min_size=0)
    rows = ts.pack_fused_weights(params, cfg, torch.bfloat16)
    panels = _panelled(rows)
    assert ts.is_int8(panels) == int8
    for name in rows:
        if name in ts._GEMMS:
            assert panels[name].dim() == 4
            assert torch.equal(ts.unpack_panels(panels[name]), rows[name])
        else:
            assert torch.equal(panels[name], rows[name])


@pytest.mark.parametrize("int8", [False, True])
def test_plain_step_reads_panels_through_the_inverse(int8):
    """Same bits from panels as from rows, and the self caches written the
    same way."""
    cfg = _small_cfg()
    g = torch.Generator().manual_seed(4)
    params = st5.init_params(cfg, g, "cpu")
    if int8:
        params = quantize_params(params, min_size=0)
    B, T, S = 3, 16, 8
    init = [torch.randn((2, B, 2, t, 64), generator=g) for t in (T, T, S, S)]
    x = torch.randn((B, 1, 128), generator=g)
    pos = torch.tensor([0, 7, 20])
    mask = torch.arange(S)[None] < torch.tensor([[8], [3], [1]])
    outs = []
    rows = ts.pack_fused_weights(params, cfg)
    for fw in (rows, _panelled(rows)):
        cache = st5.DecoderCache(*(t.clone() for t in init))
        outs.append((ts._plain_decode_step(fw, cfg, x, cache, pos, mask), cache))
    (h0, c0), (h1, c1) = outs
    assert torch.equal(h0, h1)
    assert torch.equal(c0.self_k, c1.self_k) and torch.equal(c0.self_v, c1.self_v)


# -- the JAX reference through the panel packing (as tests/test_torch_tts_step.py) --

CFG_KW = dict(
    vocab_size=40, hidden_size=64, encoder_layers=1,
    encoder_attention_heads=4, encoder_ffn_dim=96, decoder_layers=3,
    decoder_attention_heads=4, decoder_ffn_dim=96, num_mel_bins=8,
    speech_decoder_prenet_units=16, speech_decoder_postnet_units=16,
    speaker_embedding_dim=16, max_text_positions=16,
    max_speech_positions=64)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pos", [[0, 3, 7, 12], [15, 1, 8, 4]])
def test_panel_packed_plain_step_matches_jax(int8, pos):
    from infernos_tpu.models import quant as jquant

    jcfg, cfg = jst5.SpeechT5Config(**CFG_KW), st5.SpeechT5Config(**CFG_KW)
    jparams = jst5.init_params(jax.random.PRNGKey(0), jcfg)
    if int8:
        jparams = dict(jparams)
        jparams["dec_layers"] = jquant.quantize_params(jparams["dec_layers"], min_size=0)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    B, T, S = 4, 16, 8
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((3, B, 4, T, 16),) * 2 + ((3, B, 4, S, 16),) * 2]
    mask = np.tril(np.ones((B, S)))[:, ::-1].copy().astype(bool)
    mask[:, :2] = True
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    h_ref, c_ref = jst5.decode_step(jparams, jcfg, jnp.asarray(x),
                                    jst5.DecoderCache(*(jnp.asarray(a) for a in arrs)),
                                    jnp.asarray(pos, jnp.int32), enc_mask=jnp.asarray(mask))
    cache = st5.DecoderCache(*(torch.from_numpy(a.copy()) for a in arrs))
    fw = _panelled(ts.pack_fused_weights(params, cfg))
    assert fw["w1"].dim() == 4
    h = ts.fused_decode_step(params, cfg, torch.from_numpy(x), cache, torch.tensor(pos),
                             enc_mask=torch.from_numpy(mask), packed=fw)
    tol = dict(atol=1e-4, rtol=1e-4) if int8 else dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **tol)
    np.testing.assert_allclose(cache.self_k.numpy(), np.asarray(c_ref.self_k), **tol)


# -- the launch plan -----------------------------------------------------------------

def _check_plan(plan, B, int8):
    assert plan["smem_bytes"] <= ts.SMEM_MAX and plan["nslot"] >= 2
    esz = 1 if int8 else 2
    for gm in plan["gemms"]:
        K, N, G, splits = gm["K"], gm["N"], gm["G"], gm["splits"]
        P, KT = N // 16, K // 16
        assert G in (1, 2, 4, 8) and 1 <= splits <= min(KT, ts.MAX_SPLITS)
        assert gm["items"] == -(-P // G) * splits <= plan["grid"]
        covered = torch.zeros((P, KT), dtype=torch.int32)
        for item in range(gm["items"]):  # the kernel's item -> (column group, split)
            pg, s = divmod(item, splits)
            kt0, kt1 = s * KT // splits, (s + 1) * KT // splits  # as the kernel
            assert 1 <= kt1 - kt0 <= gm["max_nkt"]
            panels = range(pg * G, min(P, pg * G + G))
            covered[panels.start:panels.stop, kt0:kt1] += 1
            # the item's weights and its bias and scale fit in one slot
            assert len(panels) * (kt1 - kt0) * 256 * esz + 2 * ts.SLOT_VEC <= plan["slot_bytes"]
        assert torch.equal(covered, torch.ones_like(covered)), (K, N)
        # x rows of the item fit in its staging rows
        assert 16 * gm["max_nkt"] + 8 <= plan["xs_stride"]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", list(range(1, 33)))
def test_plan_covers_every_column_and_row_once_and_fits(B, int8):
    _check_plan(ts.step_plan(B, FULL["D"], FULL["F"], int8, FULL["grid"]), B, int8)


TINY = dict(D=256, F=768, grid=132)  # the trained tiny-real TTS on an H100


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", list(range(1, 9)))
def test_plan_found_at_tiny_real_width(B, int8):
    """The tiny-real TTS engine's widths (D 256, F 768; up to its 8 slots)
    get a plan that covers every column and K row once and fits, in both
    weight modes: no 'no plan' and no 'two slots' refusal."""
    plan = ts.step_plan(B, TINY["D"], TINY["F"], int8, TINY["grid"])
    _check_plan(plan, B, int8)
    assert [(g["K"], g["N"]) for g in plan["gemms"]] == list(ts.gemm_shapes(256, 768))


@pytest.mark.parametrize("max_tiles", [96, 64, 48, None])
@pytest.mark.parametrize("B", [1, 8, 9, 24, 25, 32])
def test_plan_caps_cover_and_fit_or_fall_back_to_the_smallest_items(B, max_tiles):
    """Plans of fewer K splits (items of at most ``max_tiles`` tiles) cover
    every column and row once and fit; where two slots of such items do not
    fit (bf16 beyond 24 slots at a cap of 96), the plan is the one of the
    smallest items, which fits for 1 to 32 slots.  The default takes the
    cap ``PLAN_MAX_TILES`` up to ``PLAN_CAP_SLOTS`` slots, the smallest
    items beyond."""
    for int8 in (False, True):
        args = (B, FULL["D"], FULL["F"], int8, FULL["grid"])
        plan = ts.step_plan(*args, max_tiles=max_tiles)
        _check_plan(plan, B, int8)
        smallest = ts.step_plan(*args, max_tiles=None)
        try:
            ts._plan(*args, max_tiles)
        except ValueError as e:
            assert "no room for two" in str(e)
            assert plan == smallest
        if max_tiles == ts.PLAN_MAX_TILES:
            assert ts.step_plan(*args) == (plan if B <= ts.PLAN_CAP_SLOTS else smallest)


def test_default_plan_takes_fewer_splits_than_the_smallest_items():
    for int8 in (False, True):
        default = ts.step_plan(8, FULL["D"], FULL["F"], int8, FULL["grid"])
        smallest = ts.step_plan(8, FULL["D"], FULL["F"], int8, FULL["grid"], max_tiles=None)
        assert sum(g["splits"] for g in default["gemms"]) < sum(
            g["splits"] for g in smallest["gemms"])


def test_plan_ints_are_what_the_kernel_reads():
    plan = ts.step_plan(8, 768, 3072, False, 132)
    ints = ts.plan_ints(plan)
    assert len(ints) == 17
    assert ints[:12] == [v for g in plan["gemms"] for v in (g["G"], g["splits"])]
    assert ints[12:] == [plan[k] for k in ("nslot", "slot_bytes", "xs_stride",
                                            "work_bytes", "smem_bytes")]
    assert plan["slot_bytes"] % 128 == 0 and plan["work_bytes"] % 128 == 0


# -- what the wrapper refuses, before it looks at the device ---------------------------

def _kernel_args(B=2, T=16, S=8, int8=False):
    cfg = _small_cfg()
    params = st5.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    if int8:
        params = quantize_params(params, min_size=0)
    fw = _panelled(ts.pack_fused_weights(params, cfg, torch.bfloat16))
    cache = st5.DecoderCache(*(torch.zeros((2, B, 2, t, 64), dtype=torch.bfloat16)
                               for t in (T, T, S, S)))
    x = torch.zeros((B, 1, 128), dtype=torch.bfloat16)
    pos = torch.zeros(B, dtype=torch.long)
    return cfg, fw, x, cache, pos


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case,match", [
    ("B33", "33 slots"), ("T4097", "T 4097"), ("S4097", "S 4097"),
    ("pos_int32", "pos must be int64"), ("mask_float", "enc_mask must be"),
    ("mask_shape", "enc_mask must be"), ("x_fp16", "x must be"), ("x_shape", "x must be"),
    ("rows_layout", "must be panels"), ("cache_fp32", "cache.self_k"),
    ("bias_bf16", "packed bso"),
])
def test_kernel_wrapper_refuses_before_the_device(int8, case, match):
    kw = {"B33": dict(B=33), "T4097": dict(T=4097), "S4097": dict(S=4097)}.get(case, {})
    cfg, fw, x, cache, pos = _kernel_args(int8=int8, **kw)
    mask = None
    if case == "pos_int32":
        pos = pos.to(torch.int32)
    elif case == "mask_float":
        mask = torch.ones((2, 8))
    elif case == "mask_shape":
        mask = torch.ones((2, 9), dtype=torch.bool)
    elif case == "x_fp16":
        x = x.to(torch.float16)
    elif case == "x_shape":
        x = x[:, 0]
    elif case == "rows_layout":
        fw = {**fw, "w1": ts.unpack_panels(fw["w1"])}
    elif case == "cache_fp32":
        cache = st5.DecoderCache(cache.self_k.float(), cache.self_v, cache.cross_k,
                                 cache.cross_v)
    elif case == "bias_bf16":
        fw = {**fw, "bso": fw["bso"].to(torch.bfloat16)}
    if case == "B33":  # taken since slot groups: 33 slots get as far as the device
        match = "CUDA"
    before = (ts.fused_decode_step.launches, ts.fused_decode_step.launches_int8)
    with pytest.raises(ValueError, match=match):
        ts._kernel_decode_step(fw, cfg, x, cache, pos, mask)
    assert (ts.fused_decode_step.launches, ts.fused_decode_step.launches_int8) == before


def test_kernel_wrapper_takes_good_cpu_inputs_as_far_as_the_device():
    for int8 in (False, True):
        cfg, fw, x, cache, pos = _kernel_args(int8=int8)
        with pytest.raises(ValueError, match="CUDA"):
            ts._kernel_decode_step(fw, cfg, x, cache, pos, torch.ones((2, 8), dtype=torch.bool))
