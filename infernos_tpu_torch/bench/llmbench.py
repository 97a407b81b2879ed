"""LLM serving benchmark: aggregate decode throughput on one card.

Matches upstream Infernos's LLM path (lockstep ``generate`` over a padded
batch) with the slot engine: ``--reqs`` requests of ``--prompt`` tokens,
``--new`` tokens each, ``--steps-per-dispatch`` decode steps per dispatch,
or speculative decode with ``--spec``.

Usage:
  python -m infernos_tpu_torch.bench.llmbench [--slots 8] [--new 48]
         [--reqs 16] [--steps-per-dispatch 8] [--spec] [--dims 7b|tiny]

Prints one JSON line with tok/s aggregate + latency percentiles.
Weights carry no values worth reading, so throughput is serving compute;
with --spec the acceptance rate reflects the weights' repetitive token
stream and is reported, not hidden.

Port of ``infernos_tpu/bench/llmbench.py``.  What differs, and why:

- It runs on the card in bf16, or on the CPU in fp32 when
  ``INFERNOS_DEVICE=cpu`` asks for it; without a card it raises.
- ``--dims 7b`` makes its weights directly in the int8 layout with
  ``cluster/model_actors.qwen_int8_init`` (zero layers, a seeded random
  embedding and readout, as the full ``LLMActor`` starts), never a dense
  bf16 copy first (15.2 GB); ``--dims tiny`` zero-fills the dense tree.
  ``--int8`` keeps the reference's quirk: it is on whatever is passed.
- ``detail.tokens`` is the tokens the engine generated (``llm.tokens``),
  beside ``value``'s count of ``reqs * new``, which assumes no EOS.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..cluster.model_actors import qwen_int8_init, zeros_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--new", type=int, default=48)
    ap.add_argument("--reqs", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--steps-per-dispatch", type=int, default=8)
    ap.add_argument("--spec", action="store_true")
    ap.add_argument("--spec-k", type=int, default=8)
    ap.add_argument("--dims", default="7b", choices=["7b", "tiny"])
    ap.add_argument("--int8", action="store_true", default=True)
    a = ap.parse_args(argv)

    import torch

    from ..models import qwen
    from ..models.tiny_real import serving_dtype
    from ..serving.llm_engine import LLMEngine, LLMEngineConfig, LLMRequest
    from ..utils.metrics import metrics
    from ..utils.platform import card_info, default_device

    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    if a.dims == "7b":
        cfg = qwen.QwenConfig(
            vocab_size=152064, hidden_size=3584, num_layers=28,
            num_heads=28, num_kv_heads=4, head_dim=128,
            intermediate_size=18944, max_positions=4096,
            eos_token_id=151645)
    else:
        cfg = qwen.QwenConfig(
            vocab_size=1024, hidden_size=256, num_layers=4, num_heads=8,
            num_kv_heads=4, head_dim=32, intermediate_size=512,
            max_positions=2048, eos_token_id=2)
    # both dims are bf16 on the reference's TPU (infernos_tpu/bench/llmbench.py);
    # on the card the tiny dims are refused
    dtype = serving_dtype(dev, tiny=False)
    if a.int8 and a.dims == "7b":
        params = qwen_int8_init(cfg, dev, dtype)
    else:
        params = zeros_init(lambda g, d, t: qwen.init_params(cfg, g, d, t),
                            dev, dtype)

    ecfg = LLMEngineConfig(
        batch_slots=a.slots, prompt_buckets=(a.prompt,),
        max_total_tokens=a.prompt + a.new + 8, max_new_tokens=a.new,
        dtype=dtype, steps_per_dispatch=a.steps_per_dispatch,
        spec_decode=a.spec, spec_k=a.spec_k)
    eng = LLMEngine(params, cfg, ecfg, device=dev)

    t0 = time.monotonic()
    eng.warmup()
    compile_s = time.monotonic() - t0

    rng = np.random.default_rng(0)
    lat = []
    done_n = [0]

    def submit_one(i):
        t_sub = time.monotonic()

        def cb(s, fin, t_sub=t_sub):
            if fin:
                lat.append(time.monotonic() - t_sub)
                done_n[0] += 1

        ids = rng.integers(3, min(cfg.vocab_size - 8, 50000),
                           size=a.prompt - 8).astype(np.int32)
        eng.submit(LLMRequest(prompt_ids=ids, sentence_cb=cb,
                              max_new_tokens=a.new))

    tokens0 = metrics.counters.get("llm.tokens", 0)
    t0 = time.monotonic()
    for i in range(a.reqs):
        submit_one(i)
    while eng.step():
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0
    total_tokens = a.reqs * a.new  # capped; EOS assumed not to fire

    snap = metrics.snapshot()
    lat.sort()
    p = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0
    out = {
        "metric": "llm_decode_tok_per_s",
        "value": round(total_tokens / wall, 1),
        "unit": f"aggregate new tokens/s ({a.dims}, batch {a.slots}, "
                f"{'spec' if a.spec else f'K={a.steps_per_dispatch}'})",
        "detail": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "card": card_info() if dev.type == "cuda" else None,
            "requests": a.reqs, "new_tokens_each": a.new,
            "prompt_tokens": a.prompt,
            "finished": done_n[0],
            "tokens": int(snap.get("llm.tokens", 0) - tokens0),
            "gen_p50_s": round(p(0.5), 2), "gen_p95_s": round(p(0.95), 2),
            "compile_s": round(compile_s, 1),
            "spec_emit_mean": round(snap.get("llm.spec_emit.mean", 0.0), 2),
            "wall_s": round(wall, 1),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
