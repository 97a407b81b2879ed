"""Batched STT benchmark over prerecorded G.711 chunks.

Synthesizes G.711 mu-law "speech", decodes it through the media-plane
codec (as a real call would), and drives the STT engine at full slot
occupancy; reports the aggregate realtime factor and per-utterance latency
percentiles.

Usage:  python -m infernos_tpu_torch.bench.sttbench [--full] [--slots 16]
            [--max-new 224] [--n 32]

Port of ``infernos_tpu/bench/sttbench.py``.  What differs, and why:

- It runs on the card, or on the CPU when ``INFERNOS_DEVICE=cpu`` asks for
  it; without a card it raises (the reference degrades to its CPU).  On
  the card it takes ``--full`` only: the tiny dims' head dim (12) is not
  one the encoder attention kernel takes.
- Weights are seeded random draws from a ``torch.Generator`` on the
  device, in the serving dtype (``models/tiny_real.serving_dtype``: bf16
  for ``--full`` on the card, fp32 otherwise); the reference draws from
  ``jax.random``.
- ``--slots``, ``--max-new`` and ``--n`` size the engine and the corpus
  (the reference's ``--full`` is 16 slots, 224 new tokens, 32 utterances,
  its defaults).  Random weights never emit EOS, so every utterance runs
  ``--max-new`` tokens.
- The result is one JSON line (the reference indents it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..audio.chunk import AudioChunk
from ..audio.codecs import G711Codec
from ..serving.stt_engine import STTEngine, STTEngineConfig, STTRequest


def make_g711_corpus(n: int = 32, min_s: float = 2.0, max_s: float = 8.0,
                     seed: int = 42) -> List[bytes]:
    """Deterministic synthetic 'speech' corpus already on the G.711 wire."""
    rng = np.random.default_rng(seed)
    codec = G711Codec()
    out = []
    for _ in range(n):
        dur = float(rng.uniform(min_s, max_s))
        t = np.arange(int(8000 * dur)) / 8000.0
        f0 = float(rng.uniform(120, 260))
        sig = (0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
               + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        out.append(codec.encode(sig))
    return out


def run_bench(engine: STTEngine, corpus: Optional[List[bytes]] = None,
              lang: str = "en") -> Dict[str, float]:
    codec = G711Codec()
    corpus = corpus or make_g711_corpus()
    results: List = []
    audio_s = [0.0]

    def cb(r):
        audio_s[0] += r.duration
        results.append(r)

    pending = list(corpus)
    t0 = time.monotonic()
    while pending or engine.n_active:
        while pending and engine.free_slots():
            payload = pending.pop(0)
            audio8k = codec.decode(payload)
            audio = AudioChunk(audio8k, 8000).resample(16000).audio
            engine.submit(STTRequest(audio=audio, text_cb=cb, lang=lang))
        if not engine.step() and not pending:
            break
    wall = time.monotonic() - t0
    lat = sorted(r.inf_time for r in results)
    return {
        "utterances": len(results),
        "audio_s": round(audio_s[0], 1),
        "wall_s": round(wall, 2),
        "realtime_factor": round(audio_s[0] / wall, 2),
        "inf_p50_s": round(lat[len(lat) // 2], 3) if lat else 0.0,
        "inf_p95_s": round(lat[int(0.95 * len(lat))], 3) if lat else 0.0,
    }


def build_engine(device, full: bool, slots: Optional[int] = None,
                 max_new: Optional[int] = None, seed: int = 0) -> STTEngine:
    """The bench's engine: whisper-large-v3 (``full``) or the tiny test
    dims, seeded random weights on ``device`` in its serving dtype."""
    import torch

    from ..models import presets
    from ..models import whisper as wsp
    from ..models.tiny_real import serving_dtype

    dtype = serving_dtype(device, tiny=not full)
    cfg = presets.WHISPER_LARGE_V3 if full else presets.WHISPER_TINY_TEST
    params = wsp.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                             device, dtype)
    ecfg = (STTEngineConfig(dtype=dtype) if full else
            STTEngineConfig(batch_slots=4, buckets_s=(2, 8), max_new_tokens=8,
                            max_prompt_tokens=8, lang_tokens={"en": 10},
                            task_transcribe=12, task_translate=13,
                            no_timestamps=14, no_speech=4, sot_prev=15,
                            dtype=dtype))
    kw = {}
    if slots:
        kw["batch_slots"] = slots
    if max_new:
        kw["max_new_tokens"] = max_new
    return STTEngine(params, cfg, dataclasses.replace(ecfg, **kw), device=device)


def main(argv=None) -> None:
    import argparse

    from ..utils.platform import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--max-new", type=int, default=None)
    ap.add_argument("--n", type=int, default=32, help="corpus utterances")
    args = ap.parse_args(argv)
    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    if dev.type == "cuda" and not args.full:
        ap.error("on the card the bench serves --full: the tiny dims' head "
                 "dim is not one the encoder attention kernel takes")
    eng = build_engine(dev, args.full, args.slots, args.max_new)
    eng.warmup()
    print(json.dumps(run_bench(eng, make_g711_corpus(n=args.n))))


if __name__ == "__main__":
    main()
