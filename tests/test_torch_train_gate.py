"""The post-retrain gate (``tools/check_bilingual.py``) through the port's
engines, and the optimiser and schedules the port's trainers share.

- The port's gate on the vendored tiny-real pair, on the CPU, passes and
  reports the reference gate's STT accuracies on both sides (the same
  draws, fp32 greedy decode); the loopback side samples the TTS (the
  reference's draws are ``jax.random``), so only its gate is held.
- ``optim.AdamW`` and the schedules against optax over whole short runs:
  the schedules at every count, AdamW's parameters after several updates
  on the same gradients (schedule read at count 0 first).
- The losses against optax's.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from infernos_tpu_torch.tools import check_bilingual, optim


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _accs(text):
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(.*) word acc: ([0-9.]+)%$", text, re.M)}


def test_gate_passes_with_the_reference_gates_stt_accuracy():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check_bilingual.main(["--device", "cpu"])
    got = _accs(buf.getvalue())
    ref = subprocess.run([sys.executable, "tools/check_bilingual.py"], capture_output=True,
                         text=True, timeout=300, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    want = _accs(ref.stdout)
    assert rc == 0 and "BILINGUAL CHECK PASSED" in buf.getvalue()
    for side in ("STT en-side", "STT pt-side"):
        assert got[side] == want[side] >= 100 * check_bilingual.GATE
    assert got["TTS->STT pt-side loopback"] >= 100 * check_bilingual.GATE


def test_gate_fails_below_80_percent(monkeypatch):
    monkeypatch.setattr(check_bilingual, "transcribe",
                        lambda eng, tok, audios, lang: ["wrong"] * len(audios))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert check_bilingual.main(["--device", "cpu"]) == 1
    assert "BILINGUAL CHECK FAILED" in buf.getvalue()


def test_gate_runs_the_tts_in_the_loaded_dtype(monkeypatch):
    """The gate's TTS engine must run in the dtype the loaders give (an
    engine config in another dtype than its trees raised at the first join
    on the card).  The rule is fp32 for the tiny-real pair on every device;
    here it is made to give bf16, on the CPU, one text a side, so that a
    config left at the fp32 default would fail."""
    from infernos_tpu_torch.models import tiny_real

    torch.set_num_threads(2)
    monkeypatch.setattr(tiny_real, "serving_dtype", lambda device, tiny: torch.bfloat16)
    monkeypatch.setattr(check_bilingual, "corpora",
                        lambda rng, n=12: {"en": ["please help"], "pt": ["favor ajuda"]})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check_bilingual.main(["--device", "cpu"])
    assert "TTS->STT pt-side loopback word acc" in buf.getvalue()


@pytest.mark.parametrize("which", ["warmup_cosine_stt_llm", "cosine_tts", "cosine_voc",
                                   "warmup_cosine_short", "constant"])
def test_schedules_match_optax_over_a_whole_run(which):
    steps = 40
    make = {
        "warmup_cosine_stt_llm": lambda m: m.warmup_cosine_decay_schedule(
            0.0, 3e-4, min(300, max(1, steps // 10)), steps, 3e-4 * 0.02),
        "warmup_cosine_short": lambda m: m.warmup_cosine_decay_schedule(
            0.0, 3e-4, 1, 3, 6e-6),
        "cosine_tts": lambda m: m.cosine_decay_schedule(3e-4, steps, alpha=0.05),
        "cosine_voc": lambda m: m.cosine_decay_schedule(2e-4, steps, alpha=0.05),
        "constant": lambda m: m.linear_schedule(1e-3, 1e-3, 0),
    }[which]
    got, want = make(optim), make(optax)
    for count in range(steps + 5):  # past the end, too
        np.testing.assert_allclose(got(count), float(want(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("wd", [1e-4, 1e-5])
def test_adamw_matches_optax_over_several_updates(wd):
    rng = np.random.default_rng(int(wd * 1e6))
    shapes = [(4, 3), (7,), (2, 2, 5)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(6)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6, 2e-4)
    opt = optax.adamw(sched, weight_decay=wd)
    jp = [jnp.asarray(x) for x in init]
    state = opt.init(jp)
    params = [torch.from_numpy(x.copy()) for x in init]
    mine = optim.AdamW(params, optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6, 2e-4),
                       weight_decay=wd)
    for i, g in enumerate(grads):
        u, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, u)
        mine.step([torch.from_numpy(x) for x in g])
        for a, b in zip(params, jp):  # fp32: within a few ulps of values near 2
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=5e-7)
        if i == 0:  # the warmup's 0.0 at count 0: the first update moves nothing
            for a, b in zip(params, init):
                np.testing.assert_array_equal(a.numpy(), b)
    assert mine.count == len(grads)


def test_losses_match_optax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        optim.softmax_cross_entropy_with_integer_labels(
            torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(optax.softmax_cross_entropy_with_integer_labels(logits, labels)),
        rtol=1e-6, atol=1e-6)
    x = rng.standard_normal((4, 9)).astype(np.float32) * 20
    y = (rng.random((4, 9)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        optim.sigmoid_binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(optax.sigmoid_binary_cross_entropy(x, y)), rtol=1e-6, atol=1e-6)


def test_the_trainers_forward_reads_the_fp32_masters_on_any_device():
    """The reference trains in fp32: ``train_step`` hands the loss the fp32
    parameters themselves (no device-dependent copy, no autocast), their
    gradients are fp32 and AdamW updates them in place; no trainer casts
    its tree or opens an autocast region."""
    p = optim.trainable({"w": torch.ones(2, 2), "n": [torch.zeros(3)], "i": torch.arange(2)})
    seen = []

    def loss_fn(params, x):
        seen.append(params)
        return (params["w"] * x).sum() + params["n"][0].sum(), None

    opt = optim.AdamW(optim.leaves(p), 0.1, weight_decay=0.0)
    optim.train_step(loss_fn, p, opt, torch.full((2, 2), 2.0))
    assert seen[0] is p and seen[0]["i"].dtype == torch.int64
    assert [t.dtype for t in optim.leaves(p)] == [torch.float32] * 2
    assert torch.allclose(p["w"], torch.full((2, 2), 0.9))  # the masters moved
    tools = os.path.join(os.path.dirname(optim.__file__))
    for name in sorted(os.listdir(tools)):
        if name.endswith(".py"):
            with open(os.path.join(tools, name)) as f:
                text = f.read()
            assert "autocast" not in text and "bfloat16" not in text, name
