"""The port's dry run and rank processes (``infernos_tpu_torch/parallel``).

- ``dryrun_multichip(2, device="cpu")``: the reference dry run's three
  parts on two gloo rank processes (TTS and STT over the slots, the LLM
  under tp 2) pass their checks, and no rank loads ``jax`` or the reference;
- ``entry()`` against the JAX package's ``__graft_entry__.entry()`` on the
  same weights (``from_jax_params``) and cache, with the reference's prenet
  dropout draws injected as the TTS parity tests do: the postnet's output
  within 1e-4 (fp32 round-off through two decoder layers and the postnet);
- a killed rank, a rank that strays from the collectives and a run past
  its deadline each make ``run_ranks`` raise, in time, naming every rank's
  exit; the group's timeout bounds a stray collective;
- ``make_mesh`` outside rank processes: one rank works, several raise; a
  mesh without a process group refuses a collective over several ranks; a
  two-axis mesh sums over each axis's own group;
- without a card and without ``device="cpu"``, ``dryrun_multichip`` and
  ``entry`` raise.
"""

import time
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.parallel import dryrun, make_mesh
from infernos_tpu_torch.parallel.mesh import Mesh
from infernos_tpu_torch.parallel.ranks import run_ranks

import torch_rank_fns as rf

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_cpu(capfd):
    res = dryrun.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out  # the ranks print through the inherited fd
    assert "backend gloo" in out and "LLM tp engine prefill+decode OK" in out
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["device"] == "cpu" and r["backend"] == "gloo"
        assert r["modules"] == []
        assert r["llm"]["cache"][2] == 1  # 2 KV heads over 2 ranks
    # each rank took its own session and its own utterance
    assert [sorted({i for i, _ in r["tts"]}) for r in res] == [[0], [1]]
    assert [[i for i, _ in r["stt"]] for r in res] == [[0], [1]]


def test_entry_matches_jax():
    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = dryrun.entry("cpu")
    jparams, jcache, jprev, jspk, _, jrng = jargs
    cfg = dryrun.tiny_cfgs(False)[0]
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    cache = st5.DecoderCache(**{f: torch.from_numpy(np.array(getattr(jcache, f)))
                                for f in jcache._fields})
    # the reference's draws: a key per step split from the chain, one per
    # prenet layer, bernoulli(p) keep masks
    keys = [jrng]

    def masks(cfg_, n_frames, generator, device):
        keys[0], sub = jax.random.split(keys[0])
        out = []
        for _ in range(cfg.speech_decoder_prenet_layers):
            sub, k = jax.random.split(sub)
            m = jax.random.bernoulli(k, cfg.speech_decoder_prenet_dropout,
                                     (n_frames, cfg.speech_decoder_prenet_units))
            out.append(torch.from_numpy(np.array(m)))
        return out

    with mock.patch.object(st5, "prenet_dropout_masks", masks), torch.no_grad():
        got = fn(params, cache, torch.from_numpy(np.array(jprev)),
                 torch.from_numpy(np.array(jspk)), torch.zeros(4, dtype=torch.long),
                 args[5])
    assert got.shape == want.shape == (4, 8, cfg.num_mel_bins)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # its own example arguments run too, with the port's own draws
    with torch.no_grad():
        own = fn(*args)
    assert own.shape == want.shape and bool(torch.isfinite(own).all())


# (rank function, its group timeout, the run's deadline) of each case below
RUNS = {"killed": (rf.dies, 30, 600), "stray": (rf.strays, 3, 600),
        "deadline": (rf.strays, 60, 3), "two_axes": (rf.two_axes, 60, 600)}


@pytest.fixture(scope="module")
def runs():
    """Every rank run of the cases below, started at once (most of their
    time is waiting): ``{case: (result or the error raised, seconds)}``."""
    from concurrent.futures import ThreadPoolExecutor

    def run(fn, timeout_s, deadline_s):
        t0 = time.monotonic()
        try:
            out = run_ranks(fn, 2, device="cpu", timeout_s=timeout_s, deadline_s=deadline_s)
        except RuntimeError as e:
            out = e
        return out, time.monotonic() - t0

    with ThreadPoolExecutor(len(RUNS)) as ex:
        futs = {k: ex.submit(run, *v) for k, v in RUNS.items()}
        yield {k: f.result() for k, f in futs.items()}


def test_killed_rank_fails_the_caller_in_time(runs):
    err, took = runs["killed"]
    assert isinstance(err, RuntimeError) and "a rank failed" in str(err)
    assert took < 30
    assert "rank 1: exit -9" in str(err) and "rank 0: exit" in str(err)


def test_stray_rank_fails_at_the_group_timeout(runs):
    err, took = runs["stray"]
    assert isinstance(err, RuntimeError) and "a rank failed" in str(err)
    assert 3 <= took < 60
    # rank 0's sum timed out; rank 1, still asleep, was killed
    assert "rank 0: exit 1" in str(err) and "rank 1: exit killed" in str(err)


def test_deadline_kills_every_rank(runs):
    err, took = runs["deadline"]
    assert isinstance(err, RuntimeError) and "deadline of 3 s passed" in str(err)
    assert took < 30
    assert "rank 1: exit killed" in str(err)


def test_make_mesh_outside_ranks():
    mesh = make_mesh(1, axes=("tp",), device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.psum(x) is x and mesh.gather_last(x, 3) is x
    with pytest.raises(RuntimeError, match="rank processes"):
        make_mesh(2, axes=("tp",), device="cpu")
    lone = Mesh(("tp",), (2,), (0,), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no process group"):
        lone.psum(x)


def test_two_axis_mesh_has_a_group_per_axis(runs):
    assert runs["two_axes"][0] == [
        ((0, 0), 3.0, 1.0, [10.0, 20.0]), ((0, 1), 3.0, 2.0, [10.0, 20.0])]


def test_dryrun_demands_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--ranks", "2"])
