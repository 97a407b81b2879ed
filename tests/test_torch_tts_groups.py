"""Kernel 2 beyond 32 slots: one launch per group of at most ``MAX_B`` slots.

``ops.tts_step.run_groups`` is the kernel wrapper's grouping.  Here each
group runs the plain step (the kernel runs only on the card, where
``chip_smoke.py`` holds it to the plain step at 40 and 48 slots): the
grouped step must equal the plain step over all slots at once -- hidden
states and every cache row -- in both weight modes, with the groups in slot
order and each one a slot slice of the same caches.
"""

import numpy as np
import pytest
import torch

from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models.quant import quantize_params
from infernos_tpu_torch.ops import tts_step as ts


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(B, int8, T=12, S=7, seed=0):
    cfg = st5.SpeechT5Config(hidden_size=128, decoder_layers=2, encoder_layers=1,
                             decoder_attention_heads=2, encoder_attention_heads=2,
                             decoder_ffn_dim=256, encoder_ffn_dim=256)
    params = st5.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    if int8:
        params = quantize_params(params, min_size=0)
    fw = ts.pack_fused_weights(params, cfg)
    g = torch.Generator().manual_seed(seed + 1)
    cache = st5.DecoderCache(*(torch.randn((2, B, 2, t, 64), generator=g)
                               for t in (T, T, S, S)))
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.integers(0, T, B)).long()
    lens = rng.integers(1, S + 1, B)
    mask = torch.from_numpy(np.arange(S)[None] < lens[:, None])
    x = torch.randn((B, 1, 128), generator=g)
    return cfg, fw, cache, pos, mask, x


def _copy(cache):
    return st5.DecoderCache(*(t.clone() for t in (cache.self_k, cache.self_v,
                                                  cache.cross_k, cache.cross_v)))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_weights", "int8_weights"])
@pytest.mark.parametrize("B", [40, 48])
def test_groups_equal_the_plain_step_over_all_slots(B, int8):
    cfg, fw, cache, pos, mask, x = _setup(B, int8, seed=B)
    whole = _copy(cache)
    groups = []

    def plain_group(xg, group, pg, mg, out):
        groups.append((xg.shape[0], group.self_k.data_ptr(), group.self_k.shape,
                       group.self_k.stride()))
        out.copy_(ts._plain_decode_step(fw, cfg, xg, group, pg, mg))

    got = ts.run_groups(plain_group, x, cache, pos, mask)
    want = ts._plain_decode_step(fw, cfg, x, whole, pos, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in ((cache.self_k, whole.self_k), (cache.self_v, whole.self_v)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # slot order: 32 slots, then the rest; each group a slot slice of the caches
    sizes = [n for n, *_ in groups]
    assert sizes == [ts.MAX_B, B - ts.MAX_B] and len(groups) == ts.launches_per_step(B)
    row = cache.self_k.stride(1) * cache.self_k.element_size()
    for (n, ptr, shape, stride), b0 in zip(groups, (0, ts.MAX_B)):
        assert ptr == cache.self_k.data_ptr() + b0 * row
        assert shape[1] == n and stride == cache.self_k.stride()


@pytest.mark.parametrize("B", [1, 8, 32])
def test_up_to_32_slots_is_one_group_on_the_whole_tensors(B):
    cfg, fw, cache, pos, mask, x = _setup(B, False)
    calls = []

    def record(xg, group, pg, mg, out):
        calls.append((xg, group, pg, mg))

    ts.run_groups(record, x, cache, pos, mask)
    assert len(calls) == 1 == ts.launches_per_step(B)
    xg, group, pg, mg = calls[0]
    assert xg.data_ptr() == x.data_ptr() and xg.shape == x.shape
    assert group.self_k.is_contiguous() and group.self_k.shape == cache.self_k.shape
    assert torch.equal(pg, pos) and torch.equal(mg, mask)


def test_fused_decode_step_takes_48_slots_on_the_cpu():
    cfg, fw, cache, pos, mask, x = _setup(48, False, seed=3)
    whole = _copy(cache)
    got = ts.fused_decode_step(None, cfg, x, cache, pos, mask, packed=fw)
    want = ts._plain_decode_step(fw, cfg, x, whole, pos, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
