"""``chip_smoke.py`` phase ``parallel``'s tensor-parallel run on the CPU.

``tp_run`` and ``tp_checks`` at tiny dims, bf16, on gloo groups of CPU rank
processes (2 ranks, then 1): the whole int8 tree made in each rank from the
phase's seed and cut to its shards, each rank's parameter bytes equal to
the budget's, the tp logits rows against the unsharded engine fed the same
inputs and both runs against fp32 activations within the phase's bounds,
the one-rank run's tokens equal to the unsharded engine's.  The card runs
the same code at Qwen2.5-14B's width.
"""

import dataclasses

import pytest
import torch

import chip_smoke as cs
from infernos_tpu_torch.models import qwen

CFG = qwen.QwenConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=8,
                      num_kv_heads=4, head_dim=8, intermediate_size=128,
                      rope_theta=10000.0, max_positions=512, eos_token_id=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    return cs.tp_run(torch, CFG, 2, device="cpu")


def test_tp_run_passes_the_phase_checks(run):
    cs.tp_checks(CFG, 2, run)
    assert max(run["errs"]) <= cs.TP_REL_TOL
    assert run["total"] == len(cs.TP_PROMPTS) + sum(
        int(s["write"].sum()) for s in run["tp"][0]["steps"])


def test_every_rank_holds_its_budget_and_its_heads(run):
    for r in run["tp"]:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["param_bytes"] == r["budget"]["weights_int8"]
        assert r["cache"][2] == CFG.num_kv_heads // 2
        assert r["modules"] == []
    assert run["one"]["param_bytes"] == run["one"]["budget"]["weights_int8"]
    # two ranks hold less than one rank does: the shards are cut
    assert run["tp"][0]["param_bytes"] < run["one"]["param_bytes"]


def test_unsharded_runs_serve_every_token(run):
    assert [len(t) for t in run["plain"]] == [cs.TP_NEW] * len(cs.TP_PROMPTS)
    assert run["one"]["tokens"] == run["plain"]
    assert set(run["vs_fp32"]) == {"unsharded_bf16", "tp2_bf16"}


def test_tree_is_the_same_in_every_process():
    """The tree the ranks make is the one the unsharded engine is held on:
    drawn from the phase's seed, quantized whole."""
    a = cs.qwen14b_tree(torch, CFG, torch.device("cpu"))
    b = cs.qwen14b_tree(torch, dataclasses.replace(CFG), torch.device("cpu"))
    assert torch.equal(a["layers"]["q"]["w_q"], b["layers"]["q"]["w_q"])
    assert torch.equal(a["lm_head"]["w"], b["lm_head"]["w"])
    assert a["layers"]["q"]["w_q"].dtype == torch.int8
    assert a["lm_head"]["w"].dtype == torch.bfloat16
