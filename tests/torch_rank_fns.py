"""Rank functions for the port's tensor-parallel tests.

``parallel.ranks.run_ranks`` starts each rank as a fresh interpreter that
imports the function it runs by module path, so these live in a module
that imports neither ``jax`` nor the reference package: the test files
(which do) hand them numpy trees and plain data.
"""

import os
import signal
import sys
import time

import numpy as np
import torch

from infernos_tpu_torch.models import qwen
from infernos_tpu_torch.models.convert import from_numpy
from infernos_tpu_torch.models.quant import quantize_params, quantize_shardings
from infernos_tpu_torch.parallel import make_mesh
from infernos_tpu_torch.parallel.mesh import shard
from infernos_tpu_torch.serving.llm_engine import LLMEngine, LLMEngineConfig, LLMRequest


def collect(engine, prompts):
    """Each prompt's ``(sentence, final)`` stream, stepped to the end."""
    outs = {i: [] for i in range(len(prompts))}
    for i, p in enumerate(prompts):
        engine.submit(LLMRequest(np.asarray(p, np.int64),
                                 lambda s, f, i=i: outs[i].append((s, f))))
    while engine.step():
        pass
    return outs


def tp_params(params_np, cfg, mesh, quantize_min_size=None):
    """The numpy tree as this rank's shards: quantized whole first when
    ``quantize_min_size`` is given, then cut under the specs."""
    params = from_numpy(params_np, "cpu")
    specs = qwen.param_shardings(cfg)
    if quantize_min_size is not None:
        params = quantize_params(params, min_size=quantize_min_size)
        specs = quantize_shardings(specs, params)
    return shard(params, specs, mesh)


def engine_tokens(params_np, cfg, ecfg, runs, quantize_min_size=None):
    """One ``tp`` engine per rank; ``runs``: prompt lists collected one
    after another on the same engine.  Returns the streams and the cache's
    shape on this rank."""
    mesh = make_mesh(axes=("tp",), device="cpu")
    eng = LLMEngine(tp_params(params_np, cfg, mesh, quantize_min_size), cfg, ecfg,
                    mesh=mesh)
    outs = [collect(eng, prompts) for prompts in runs]
    return outs, tuple(eng.cache.k.shape)


def tp_suite(params_np, cfg, prompts, int8_prompt, int8_floor, hf=None):
    """What ``test_torch_llm_tp.py`` holds, on one ``tp`` group: the engine
    over three prompts (two slots), a queued join (one slot), the int8
    engine (the tree quantized whole, then sharded), speculative decode
    (``qwen.verify_steps`` under tp) and, with ``hf`` (a numpy tree, its
    config and tokens), a prefill's logits."""
    import dataclasses

    mesh = make_mesh(axes=("tp",), device="cpu")
    ecfg = LLMEngineConfig(batch_slots=2, prompt_buckets=(16,), max_total_tokens=48,
                           max_new_tokens=8)
    eng = LLMEngine(tp_params(params_np, cfg, mesh), cfg, ecfg, mesh=mesh)
    out = {"matches": collect(eng, prompts), "cache": tuple(eng.cache.k.shape)}
    eng = LLMEngine(tp_params(params_np, cfg, mesh), cfg,
                    dataclasses.replace(ecfg, batch_slots=1, max_new_tokens=6), mesh=mesh)
    out["direct"] = collect(eng, [prompts[0]])[0]
    out["queued"] = collect(eng, [prompts[1], prompts[0]])
    eng = LLMEngine(tp_params(params_np, cfg, mesh, int8_floor), cfg, ecfg, mesh=mesh)
    out["int8"] = collect(eng, [int8_prompt])[0]
    eng = LLMEngine(tp_params(params_np, cfg, mesh), cfg,
                    dataclasses.replace(ecfg, spec_decode=True, spec_k=4), mesh=mesh)
    out["spec"] = collect(eng, prompts)
    if hf is not None:
        hparams, hcfg, toks = hf
        logits, _, _ = qwen.prefill(tp_params(hparams, hcfg, mesh), hcfg,
                                    torch.from_numpy(toks), mesh=mesh)
        out["prefill"] = logits.numpy()
    return out


def prefill_logits(params_np, cfg, tokens):
    """``qwen.prefill`` of ``tokens`` on this rank's shards: the whole
    logits and this rank's K stack."""
    mesh = make_mesh(axes=("tp",), device="cpu")
    params = tp_params(params_np, cfg, mesh)
    logits, ks, _ = qwen.prefill(params, cfg, torch.from_numpy(tokens), mesh=mesh)
    return logits.numpy(), ks.numpy()


def loaded_modules():
    """The modules of ``jax``, ``jaxlib`` or the reference package this
    rank loaded, after one ``tp`` decode of the tiny config."""
    cfg = qwen.QwenConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                          num_kv_heads=2, head_dim=8, intermediate_size=32,
                          max_positions=64, eos_token_id=2)
    params = qwen.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_mesh(axes=("tp",), device="cpu")
    eng = LLMEngine(shard(params, qwen.param_shardings(cfg), mesh), cfg,
                    LLMEngineConfig(batch_slots=1, prompt_buckets=(8,),
                                    max_total_tokens=16, max_new_tokens=3),
                    mesh=mesh)
    collect(eng, [[3, 4, 5]])
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "infernos_tpu"))


def two_axes():
    """A ``(dp 1, tp 2)`` mesh: each rank's coordinates and its sums of
    ``rank + 1`` over each axis (the ``tp`` group holds both ranks, each
    ``dp`` group one)."""
    mesh = make_mesh(axes=("dp", "tp"), shape=(1, 2), device="cpu")
    x = torch.tensor([float(mesh.rank + 1)])
    return (mesh.coords, float(mesh.psum(x, "tp")), float(mesh.psum(x, "dp")),
            mesh.gather_last(torch.tensor([10.0 * (mesh.rank + 1)]), 2, "tp").tolist())


def dies():
    """Rank 1 is killed; rank 0 waits in a sum that rank 1 never joins."""
    mesh = make_mesh(axes=("tp",), device="cpu")
    if mesh.rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    mesh.psum(torch.ones(4))
    time.sleep(120)


def strays():
    """Rank 1 stays alive but takes another path; rank 0's sum waits until
    the group's timeout fails it."""
    mesh = make_mesh(axes=("tp",), device="cpu")
    if mesh.rank == 1:
        time.sleep(120)
    mesh.psum(torch.ones(4))
