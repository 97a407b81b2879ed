"""Port's VAD (model, slot-batched classes, worker) vs the JAX package's.

The same numpy windows and the same weights (the vendored trained
``vad_weights.npz`` and a random tree carried over by ``from_jax_params``)
go through both.  Probabilities and LSTM state must agree to 1e-5 over
several chained windows (fp32 in both; the FFT and the sums run in another
order).  With ``slots=`` the port's ``NeuralVAD`` must behave as the JAX
package's ``NumpyVAD`` does: the state of a slot it was not given does not
move.
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from infernos_tpu.audio.codecs.g711 import G711Codec as JG711
from infernos_tpu.models import vad as jvad
from infernos_tpu.serving import vad_engine as jve
from infernos_tpu_torch.audio.codecs.g711 import G711Codec
from infernos_tpu_torch.models import vad
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.serving import vad_engine as ve

TOL = dict(rtol=1e-5, atol=1e-5)
CFG, JCFG = vad.VADConfig(), jvad.VADConfig()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(kind):
    if kind == "trained":
        jparams = jvad.load_pretrained()
        assert jparams is not None, "vendored vad_weights.npz missing"
    else:
        jparams = jvad.init_params(jax.random.PRNGKey(5), JCFG)
        # a nonzero LSTM bias, so that it counts
        for lp in jparams["lstm"]:
            lp["b"] = lp["b"] + 0.1
    return jparams, from_jax_params(_np(jparams), "cpu")


def _windows(rng, B, n):
    """Chained windows: speech-like tones, noise and near silence."""
    t = np.arange(CFG.window) / CFG.sample_rate
    out = []
    for k in range(n):
        rows = []
        for b in range(B):
            kind = (b + k) % 3
            if kind == 0:
                f0 = rng.uniform(100, 250)
                w = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6)) * 0.2
            elif kind == 1:
                w = 0.05 * rng.standard_normal(CFG.window)
            else:
                w = 1e-4 * rng.standard_normal(CFG.window)
            rows.append(w)
        out.append(np.stack(rows).astype(np.float32))
    return out


def test_config_matches_reference():
    import dataclasses

    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


@pytest.mark.parametrize("kind", ["trained", "random"])
def test_apply_matches_jax_over_chained_windows(kind):
    jparams, params = _weights(kind)
    B = 5
    jstate = jvad.init_state(JCFG, B)
    state = vad.init_state(CFG, B, "cpu")
    probs = []
    for w in _windows(np.random.default_rng(0), B, 6):
        want, jstate = jvad.apply(jparams, JCFG, w, jstate)
        got, state = vad.apply(params, CFG, torch.from_numpy(w), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h), **TOL)
        np.testing.assert_allclose(state.c.numpy(), np.asarray(jstate.c), **TOL)
        probs.append(np.asarray(want))
    probs = np.stack(probs)
    if kind == "trained":  # the inputs exercise both sides of the threshold
        assert probs.max() > 0.9 and probs.min() < 0.1


def test_load_pretrained_is_the_vendored_tree():
    jparams, _ = _weights("trained")
    params = vad.load_pretrained("cpu")
    flat_j = jax.tree_util.tree_leaves(_np(jparams))
    flat_t = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), params))
    assert len(flat_j) == len(flat_t) == 12
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)


def test_init_params_has_the_reference_tree():
    jparams, _ = _weights("random")
    params = vad.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    jshape = jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jparams))
    tshape = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert jshape == tshape


@pytest.mark.parametrize("kind", ["trained", "random"])
def test_neural_vad_slots_match_numpy_vad_and_idle_slot_stays(kind):
    jparams, params = _weights(kind)
    B = 6
    ref = jvad.NumpyVAD(jparams, JCFG, B)
    mine = vad.NeuralVAD(params, CFG, B, device="cpu")
    own_np = vad.NumpyVAD(jax.tree_util.tree_map(lambda t: t.numpy(), params), CFG, B)
    assert mine.supports_slots and ref.supports_slots
    rng = np.random.default_rng(1)
    # slot 4 speaks once, then sits idle while the others go on
    first = np.array([0, 2, 4])
    w0 = _windows(rng, 3, 1)[0]
    for m in (ref, mine, own_np):
        m(w0, slots=first)
    idle_h = mine.state.h[:, 4].clone()
    idle_c = mine.state.c[:, 4].clone()
    assert float(idle_h.abs().max()) > 0  # it did move when it was given
    busy = np.array([2, 0, 5])  # another order, and a slot not seen before
    for w in _windows(rng, 3, 4):
        want = ref(w, slots=busy)
        got = mine(w, slots=busy)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(own_np(w, slots=busy), want, **TOL)
    torch.testing.assert_close(mine.state.h[:, 4], idle_h, rtol=0, atol=0)
    torch.testing.assert_close(mine.state.c[:, 4], idle_c, rtol=0, atol=0)
    np.testing.assert_allclose(mine.state.h.numpy(), ref.h, **TOL)
    np.testing.assert_allclose(mine.state.c.numpy(), ref.c, **TOL)
    # slots 1 and 3 were never given: still zero
    assert float(mine.state.h[:, [1, 3]].abs().max()) == 0.0
    mine.reset_channel(2)
    ref.reset_channel(2)
    np.testing.assert_allclose(mine.state.h.numpy(), ref.h, **TOL)
    assert float(mine.state.c[:, 2].abs().max()) == 0.0


def test_neural_vad_full_batch_matches_jax_neural_vad():
    jparams, params = _weights("trained")
    B = 3
    ref = jvad.NeuralVAD(jparams, JCFG, B)
    mine = vad.NeuralVAD(params, CFG, B, device="cpu")
    for w in _windows(np.random.default_rng(2), B, 3):
        np.testing.assert_allclose(mine(w), ref(w), **TOL)


def test_energy_vad_matches_reference():
    ref, mine = jvad.EnergyVAD(4), vad.EnergyVAD(4)
    for w in _windows(np.random.default_rng(3), 4, 5):
        np.testing.assert_array_equal(mine(w), ref(w))
    np.testing.assert_array_equal(mine.floor, ref.floor)


def _render(text, seed):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from speechlang import Speaker, render_text

    rng = np.random.default_rng(seed)
    return render_text(rng, text, Speaker.random(rng)).astype(np.float32)


def _segments(mod_ve, codec, model_factory, payload):
    """Feed 20 ms mu-law payloads through a worker + channel; the segments
    as (start sample, n samples, audio) and every window's activity flag."""
    segs, flags = [], []
    done = threading.Event()
    worker = mod_ve.VADWorker(model_factory)
    n_windows = len(payload) // 160 * 160 // 768  # whole 20 ms payloads are fed

    def audio_in(chunk, active):
        flags.append(active)
        if len(flags) == n_windows:
            done.set()

    ch = mod_ve.VADChannel(audio_in, lambda c: segs.append(
        (c.ipos, len(c.audio), np.asarray(c.audio).copy())), codec)
    worker.start()
    try:
        for i in range(0, len(payload) - 159, 160):
            ch.ingest(worker, payload[i:i + 160])
        assert done.wait(timeout=60), "VAD worker did not finish in time"
    finally:
        worker.stop(join=False)
        worker.join(timeout=10)
    assert not worker.is_alive()
    return segs, flags


def test_worker_and_channel_give_the_reference_segments():
    jparams, params = _weights("trained")
    sil = np.zeros(4000, np.float32)
    from infernos_tpu.audio.resample import resample

    wav = np.concatenate([sil, resample(_render("one two three", 1), 16000, 8000),
                          sil, sil,
                          resample(_render("help me now", 2), 16000, 8000), sil, sil])
    payload = JG711().encode(wav)
    assert payload == G711Codec().encode(wav)
    want, wflags = _segments(jve, JG711(),
                             lambda n: jvad.NumpyVAD(jparams, JCFG, n), payload)
    got, gflags = _segments(ve, G711Codec(),
                            lambda n: vad.NeuralVAD(params, CFG, n, device="cpu"),
                            payload)
    assert len(want) >= 2, "the rendered utterances gave no two segments"
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    assert gflags == wflags
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("probs,events", [
    ([0.9, 0.9, 0.1, 0.1, 0.1], None),
    ([0.1, 0.6, 0.4, 0.2, 0.2, 0.2, 0.7, 0.1, 0.1, 0.1], None),
    ([0.5, 0.34, 0.36, 0.34, 0.34], None),
])
def test_vad_iterator_matches_reference(probs, events):
    a, b = ve.VADIterator(), jve.VADIterator()
    assert [a.step(p, 768) for p in probs] == [b.step(p, 768) for p in probs]
    assert (a.triggered, a.temp_end, a.current_sample) == \
        (b.triggered, b.temp_end, b.current_sample)


def test_zlib_vad_matches_reference():
    rng = np.random.default_rng(4)
    data = (bytes(rng.integers(0, 256, 8000, dtype=np.uint8)) + b"\xff" * 8000) * 2
    outs = []
    for cls in (ve.ZlibVAD, jve.ZlibVAD):
        z, got, acts = cls(), [], []
        for i in range(0, len(data), 160):
            r = z.ingest(data[i:i + 160], lambda c, a: acts.append(a))
            if r is not None:
                got.append(r)
        outs.append((got, acts))
    assert outs[0] == outs[1] and len(outs[0][0]) >= 1
