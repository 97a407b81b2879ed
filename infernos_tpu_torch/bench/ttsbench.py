"""Deterministic concurrent-session TTS benchmark.

N concurrent seeded sessions stream through the engine; per session it
reports ``time_to_first_frame``, ``time_to_last_frame``, frame count, and
``rtr`` (real-time ratio: audio seconds produced per wall second); optional
``out_<n>.wav`` outputs for listening checks.  Every draw is seeded, so
runs are reproducible.

Usage:  python -m infernos_tpu_torch.bench.ttsbench [N] [--full]
            [--max-frames 128]

Port of ``infernos_tpu/bench/ttsbench.py``.  What differs, and why:

- The engine's weights come from a ``torch.Generator`` seeded with
  ``seed`` on the engine's device (the reference splits a ``jax.random``
  key); its dtype is the serving dtype (``models/tiny_real
  .serving_dtype``: bf16 for ``--full`` on the card, fp32 otherwise).
- ``run_bench`` and ``main`` run on the card, or on the CPU when asked
  (``device="cpu"``, ``INFERNOS_DEVICE=cpu``); without a card they raise.
  On the card ``main`` takes ``--full`` only: the tiny dims are not ones
  the decoder-step kernel takes.
- ``main`` prints one JSON line: the summary and each session's frames.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..audio.chunk import AudioChunk
from ..models.tokenizers import CharTokenizer
from ..serving.speakers import SpeakerBank
from ..serving.tts_engine import TTSEngine, TTSEngineConfig

PROMPTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Speech synthesis under hard real-time constraints.",
    "Twenty milliseconds per packet, every packet.",
    "Numbers like 42 and 1234 get spelled out.",
    "A framework rebuilt for tensor processing units.",
]


@dataclasses.dataclass
class SessionReport:
    session: int
    time_to_first_frame: float
    time_to_last_frame: float
    frames: int
    rtr: float  # real-time ratio (audio_s / wall_s)


def build_engine(tiny: bool = True, seed: int = 42, max_frames: int = 128,
                 device=None) -> TTSEngine:
    """The bench's engine: 8 slots, seeded random SpeechT5 + HiFi-GAN (the
    tiny dims or the full ones) in the device's serving dtype."""
    import torch

    from ..models import hifigan as hfg
    from ..models import presets
    from ..models import speecht5 as st5
    from ..models.tiny_real import serving_dtype
    from ..utils.platform import default_device

    dev = default_device(device)
    dtype = serving_dtype(dev, tiny=tiny)
    cfg = presets.SPEECHT5_TINY if tiny else presets.SPEECHT5_FULL
    voc = presets.HIFIGAN_TINY if tiny else presets.HIFIGAN_FULL
    g = torch.Generator(device=dev).manual_seed(seed)
    return TTSEngine(
        st5.init_params(cfg, g, dev, dtype), cfg,
        hfg.init_params(voc, g, dev, dtype), voc,
        TTSEngineConfig(batch_slots=8, max_text_tokens=64,
                        max_steps=max_frames // 2 + 8,
                        chunk_schedule=(8, 32), stop_threshold=2.0,
                        dtype=dtype),
        device=dev)


def run_bench(n_sessions: int = 50, tiny: bool = True, seed: int = 42,
              max_frames: int = 128, wav_dir: Optional[str] = None,
              engine: Optional[TTSEngine] = None,
              device=None) -> List[SessionReport]:
    rng = np.random.default_rng(seed)
    if engine is None:
        engine = build_engine(tiny, seed, max_frames, device)
        engine.warmup()
    cfg = engine.cfg
    tok = CharTokenizer()
    bank = SpeakerBank.synthetic(dim=cfg.speaker_embedding_dim)
    sr = engine.ecfg.sample_rate

    state: Dict[int, dict] = {}
    pending = list(range(n_sessions))
    reports: List[SessionReport] = []

    def start(i: int) -> None:
        st = state[i] = {"t0": time.monotonic(), "first": None, "last": None,
                         "samples": 0, "audio": [] if wav_dir else None}

        def cb(audio):
            now = time.monotonic()
            if audio is None:
                st["last"] = now
                reports.append(SessionReport(
                    session=i,
                    time_to_first_frame=(st["first"] or now) - st["t0"],
                    time_to_last_frame=now - st["t0"],
                    frames=st["samples"] // 256,
                    rtr=(st["samples"] / sr) / max(now - st["t0"], 1e-9),
                ))
                if wav_dir and st["audio"]:
                    AudioChunk(np.concatenate(st["audio"]), sr).save_wav(
                        f"{wav_dir}/out_{i}.wav")
                return
            if st["first"] is None:
                st["first"] = now
            st["samples"] += len(audio)
            if st["audio"] is not None:
                st["audio"].append(audio)

        engine.start_session(
            tok(PROMPTS[i % len(PROMPTS)]),
            bank.get(int(rng.integers(0, len(bank)))),
            cb, max_frames=max_frames)

    B = engine.ecfg.batch_slots
    while pending or engine.n_active or engine._pending:
        # joins are deferred+batched: throttle submissions to the slot
        # count so queue_wait stays a join-latency metric, not an overload
        while pending and engine.n_active + len(engine._pending) < B:
            start(pending.pop(0))
        if not engine.step() and not pending:
            break
    return sorted(reports, key=lambda r: r.session)


def summarize(reports: List[SessionReport]) -> Dict[str, float]:
    ttff = sorted(r.time_to_first_frame for r in reports)
    rtrs = [r.rtr for r in reports]
    return {
        "sessions": len(reports),
        "ttff_p50": ttff[len(ttff) // 2],
        "ttff_p95": ttff[min(len(ttff) - 1, int(0.95 * len(ttff)))],
        "rtr_mean": float(np.mean(rtrs)),
        "rtr_min": float(np.min(rtrs)),
    }


def main(argv=None) -> None:
    import argparse

    from ..utils.platform import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("n_sessions", type=int, nargs="?", default=50)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--max-frames", type=int, default=128)
    args = ap.parse_args(argv)
    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    if dev.type == "cuda" and not args.full:
        ap.error("on the card the bench serves --full: the tiny dims are not "
                 "ones the decoder-step kernel takes")
    reps = run_bench(n_sessions=args.n_sessions, tiny=not args.full,
                     max_frames=args.max_frames, device=dev)
    print(json.dumps({**summarize(reps), "frames": [r.frames for r in reps]}))


if __name__ == "__main__":
    main()
