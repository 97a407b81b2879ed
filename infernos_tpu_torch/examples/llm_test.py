"""LLM serving latency test: N concurrent self-re-queuing timed sessions.

Port of ``examples/llm_test.py``: many concurrent sessions each submit a
request, time it, and submit the next one from its final callback for a
fixed number of rounds; prints per-round latency percentiles.

Run: python -m infernos_tpu_torch.examples.llm_test [n_sessions] [rounds] [--full]

What differs, and why:

- It runs on the card, or on the CPU when ``INFERNOS_DEVICE=cpu`` asks
  for it; without a card it raises.  The tiny dims are fp32 on every
  device, ``--full`` bf16 on the card (``models/tiny_real.serving_dtype``).  The
  weights come from a ``torch.Generator`` seeded 0 (the reference's
  ``jax.random.PRNGKey(0)``); ``--full`` is Qwen2.5-14B's dims.
- The port's engine queues a submit and joins it at its next step, so a
  session submits straight from its callback (which runs inside
  ``step``) instead of stepping the engine until a slot is free.
- ``main`` returns the latencies, one per request.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional


def main(n_sessions: int = 16, rounds: int = 3, tiny: bool = True,
         device=None) -> List[float]:
    import torch

    from ..models import presets, qwen
    from ..models.tiny_real import serving_dtype
    from ..models.tokenizers import ByteTokenizer
    from ..serving.llm_engine import LLMEngine, LLMEngineConfig, LLMRequest
    from ..utils.platform import default_device

    dev = default_device(device or os.environ.get("INFERNOS_DEVICE") or None)
    dtype = serving_dtype(dev, tiny=tiny)
    cfg = presets.QWEN_TINY if tiny else presets.QWEN25_14B
    tok = ByteTokenizer()
    eng = LLMEngine(
        qwen.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, dtype), cfg,
        LLMEngineConfig(batch_slots=8, prompt_buckets=(64, 128),
                        max_total_tokens=256, max_new_tokens=32, dtype=dtype),
        detokenize=tok.detokenize, device=dev)
    t0 = time.monotonic()
    eng.warmup()
    print(f"device={dev} tiny={tiny}; warmup: {time.monotonic() - t0:.1f}s")

    lat: List[float] = []
    pending = {"n": 0}

    def submit(sess_i: int, round_i: int) -> None:
        if round_i >= rounds:
            return
        t_start = time.monotonic()
        prompt = tok(f"session {sess_i} round {round_i}: say something.")

        def cb(text: str, is_final: bool) -> None:
            if not is_final:
                return
            lat.append(time.monotonic() - t_start)
            pending["n"] -= 1
            submit(sess_i, round_i + 1)

        eng.submit(LLMRequest(prompt_ids=prompt, sentence_cb=cb))
        pending["n"] += 1

    t0 = time.monotonic()
    for i in range(n_sessions):
        submit(i, 0)
    while eng.step() or pending["n"] > 0:
        if not eng.n_active and pending["n"] == 0:
            break
    wall = time.monotonic() - t0
    done = sorted(lat)
    n = len(done)
    print(f"{n} requests in {wall:.1f}s ({n / wall:.1f} req/s)")
    print(f"latency p50={done[n // 2]:.3f}s p95={done[int(0.95 * n)]:.3f}s "
          f"max={done[-1]:.3f}s")
    return lat


def cli(argv: Optional[List[str]] = None) -> List[float]:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    return main(n_sessions=int(args[0]) if args else 16,
                rounds=int(args[1]) if len(args) > 1 else 3,
                tiny="--full" not in argv)


if __name__ == "__main__":
    cli()
