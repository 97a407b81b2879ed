"""Port's tiered STT facade vs the JAX package's, on the CPU.

Routing at ``short_max_s`` (the boundary length goes to the short tier), one
parameter tree shared by both tiers, and, on the in-repo trained tiny
Whisper (``tiny_stt``), the same token ids and text as the JAX
``TieredSTTEngine`` for one short and one long utterance.  Token ids are
compared, not stop points: ``max_new_tokens`` is capped in both.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from infernos_tpu.models import tiny_real
from infernos_tpu.serving import stt_engine as jstt
from infernos_tpu.serving import stt_tiered as jtier
from infernos_tpu_torch.models import whisper as wsp
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.serving import stt_engine as stt
from infernos_tpu_torch.serving import stt_tiered as tier


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_cfg(cls, obj, **kw):
    fields = {f: getattr(obj, f) for f in cls.__dataclass_fields__ if hasattr(obj, f)}
    fields.update(kw)
    return cls(**fields)


def _render(text, seed):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from speechlang import Speaker, render_text

    rng = np.random.default_rng(seed)
    return render_text(rng, text, Speaker.random(rng)).astype(np.float32)


TINY = wsp.WhisperConfig(
    vocab_size=64, num_mel_bins=16, d_model=32, encoder_layers=1,
    encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
    ffn_dim=64, max_source_positions=100, max_target_positions=32,
    eos_token_id=2, sot_token_id=3, no_speech_token_id=4)
BASE = dict(batch_slots=2, buckets_s=(1, 2), sample_rate=16000, max_new_tokens=6,
            max_prompt_tokens=8, lang_tokens={"en": 10}, task_transcribe=12,
            task_translate=13, no_timestamps=14, no_speech=4)


@pytest.fixture(scope="module")
def eng():
    params = wsp.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    tcfg = tier.TieredSTTConfig(short_max_s=1, short_slots=3, long_slots=2,
                                base=stt.STTEngineConfig(**BASE))
    return tier.TieredSTTEngine(params, TINY, tcfg, device="cpu")


def _audio(n, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def test_tier_configs_match_reference():
    jt = jtier.TieredSTTConfig(short_max_s=1, short_slots=3, long_slots=2,
                               base=jstt.STTEngineConfig(**BASE))
    t = tier.TieredSTTConfig(short_max_s=1, short_slots=3, long_slots=2,
                             base=stt.STTEngineConfig(**BASE))
    for mine, ref in ((t.short_ecfg(), jt.short_ecfg()), (t.long_ecfg(), jt.long_ecfg())):
        assert (mine.batch_slots, tuple(mine.buckets_s)) == \
            (ref.batch_slots, tuple(ref.buckets_s))
    assert tier.TieredSTTConfig().dtype == torch.float32
    d, jd = tier.TieredSTTConfig(), jtier.TieredSTTConfig()
    assert (d.short_max_s, d.short_slots, d.long_slots) == \
        (jd.short_max_s, jd.short_slots, jd.long_slots)


@pytest.mark.parametrize("n,want", [(16000, "short"), (16001, "long"),
                                    (8000, "short"), (27200, "long")])
def test_routes_at_short_max_s(eng, n, want):
    req = stt.STTRequest(audio=_audio(n), text_cb=lambda r: None)
    assert eng._route(req) is getattr(eng, want)


def test_tiers_share_one_parameter_tree(eng):
    assert eng.short.params is eng.long.params
    assert eng.short.ecfg.batch_slots == 3 and eng.long.ecfg.batch_slots == 2
    assert eng.ecfg is eng.long.ecfg and eng.device == torch.device("cpu")
    assert len(eng.free_slots()) == 5


def test_decodes_both_tiers_and_matches_untiered(eng):
    out = []
    eng.submit(stt.STTRequest(audio=_audio(8000, 1), text_cb=out.append))
    eng.submit(stt.STTRequest(audio=_audio(27200, 2), text_cb=out.append))
    eng.step()  # submits are deferred; the first step joins them
    assert eng.short.n_active == 1 and eng.long.n_active == 1 and eng.n_active == 2
    for _ in range(100):
        if not eng.step():
            break
    assert sorted(r.duration for r in out) == [0.5, 1.7]
    solo = stt.STTEngine(eng.short.params, TINY, eng.short.ecfg, device="cpu")
    got = []
    solo.submit(stt.STTRequest(audio=_audio(8000, 1), text_cb=got.append))
    for _ in range(100):
        if not solo.step():
            break
    short = next(r for r in out if r.duration == 0.5)
    assert got[0].tokens == short.tokens


def test_abort_all_flushes_live_and_queued(eng):
    out = []
    for i in range(5):  # 3 short slots: two stay queued
        eng.submit(stt.STTRequest(audio=_audio(8000, i), text_cb=out.append))
    eng.step()
    eng.abort_all("test")
    assert len(out) == 5 and all(r.tokens == [] and r.no_speech_prob == 1.0
                                 for r in out)
    assert eng.n_active == 0 and not eng.step()


def _run(engine, req_cls, audios):
    out = {}
    for i, a in enumerate(audios):
        engine.submit(req_cls(audio=a.copy(), text_cb=lambda r, i=i: out.__setitem__(i, r)))
    for _ in range(500):
        if not engine.step():
            break
    return [out[i] for i in range(len(audios))]


def test_same_tokens_as_jax_tiered_engine_on_tiny_real():
    if not tiny_real.have_tiny_stt():
        pytest.fail("vendored tiny_stt checkpoint missing")
    jparams, jcfg, tok, jecfg = tiny_real.load_tiny_stt()
    jecfg = dataclasses.replace(jecfg, max_new_tokens=24)
    short = _render("one two", 1)
    long_ = _render("help me now one two three", 2)
    assert len(short) <= 2 * 16000 < len(long_) <= 5 * 16000, (len(short), len(long_))
    jeng = jtier.TieredSTTEngine(
        jparams, jcfg, jtier.TieredSTTConfig(short_max_s=2, short_slots=3,
                                             long_slots=2, base=jecfg),
        detokenize=tok.detokenize)
    want = _run(jeng, jstt.STTRequest, [short, long_])
    assert len(jeng.short.ecfg.buckets_s) == 1
    cfg = _same_cfg(wsp.WhisperConfig, jcfg)
    ecfg = _same_cfg(stt.STTEngineConfig, jecfg, dtype=torch.float32)
    eng = tier.TieredSTTEngine(
        from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu"), cfg,
        tier.TieredSTTConfig(short_max_s=2, short_slots=3, long_slots=2, base=ecfg),
        detokenize=tok.detokenize, device="cpu")
    assert tuple(eng.short.ecfg.buckets_s) == tuple(jeng.short.ecfg.buckets_s)
    got = _run(eng, stt.STTRequest, [short, long_])
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and len(w.tokens) > 0
        assert g.text == w.text
    assert len(eng.short.encode_ms) == 1 and len(eng.long.encode_ms) == 1
