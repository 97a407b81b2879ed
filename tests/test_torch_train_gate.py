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


def test_forward_params_are_bf16_on_the_card_only_and_differentiable():
    p = optim.trainable({"w": torch.ones(2, 2), "n": [torch.zeros(3)], "i": torch.arange(2)})
    assert optim.forward_params(p, "cpu") is p
    fp = optim.map_tree(lambda t: t.to(torch.bfloat16), p)  # what the card's forward reads
    assert fp["w"].dtype == torch.bfloat16 and fp["i"].dtype == torch.int64
    fp["w"].float().sum().backward()
    assert p["w"].grad.dtype == torch.float32 and torch.equal(p["w"].grad, torch.ones(2, 2))
    assert [t.dtype for t in optim.leaves(p)] == [torch.float32] * 2
