"""TTS paced-calls benchmark body: the flagship entry's TTS component.

The north-star metric is denominated in **concurrent paced calls**, each
consuming audio at exactly 1x real time through a 20 ms pacer, not in
aggregate audio-sec/wall-sec.  This bench drives N simulated calls through
the streaming engine with utterance-level slot multiplexing and
sentence-done flow control (the reference's ``tts_say_done`` protocol),
ramping N until the SLA breaks: p95 utterance TTFB < 200 ms and zero pacer
underruns.

Prints ONE JSON line:
  {"metric": "tts_paced_concurrent_calls_per_chip", "value": N, ...}

Port of ``infernos_tpu/bench/ttsmain.py``.  What differs, and why:

- It runs on the card, or on the CPU when ``INFERNOS_DEVICE=cpu`` asks for
  it; without a card it raises (the reference measured on its CPU instead).
- Full SpeechT5 + HiFi-GAN dims with zero weights allocated on the device
  in the serving dtype (bf16 on the card; ``cluster.model_actors
  .zeros_init``, no fp32 copy): weight values are irrelevant to serving
  throughput.  ``BENCH_INT8`` quantizes the decoder through
  ``models/quant.py``, which runs the step kernel's int8 mode.
- ``BENCH_SLOTS`` may exceed the step kernel's ``MAX_B`` (32) on the card:
  a step of more slots is one launch per group of at most 32 slots.
- ``detail`` names the card (``utils.platform.card_info``).  No baseline
  ratio is printed: the reference's figures were measured on other
  hardware.  ``BENCH_MODE=streams`` prints the throughput probe instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch


def build_engine(device, B: int, chunk_schedule, max_steps: int,
                 int8: bool = False):
    """A TTS engine at full SpeechT5 + HiFi-GAN width with zero weights on
    ``device`` in its serving dtype; the decoder quantized when ``int8``."""
    from ..cluster.model_actors import zeros_init
    from ..models import hifigan as hfg
    from ..models import presets
    from ..models import speecht5 as st5
    from ..models.tiny_real import serving_dtype
    from ..serving.tts_engine import TTSEngine, TTSEngineConfig

    cfg, voc = presets.SPEECHT5_FULL, presets.HIFIGAN_FULL
    dtype = serving_dtype(device, tiny=False)
    params = zeros_init(lambda g, d, t: st5.init_params(cfg, g, d, t), device, dtype)
    voc_params = zeros_init(lambda g, d, t: hfg.init_params(voc, g, d, t), device, dtype)
    if int8:
        from ..models import quant

        params = quant.quantize_params(params)
    ecfg = TTSEngineConfig(
        batch_slots=B,
        max_text_tokens=64,
        max_steps=max_steps,
        pre_frames=4,
        chunk_schedule=chunk_schedule,
        min_steps=8,
        stop_threshold=2.0,  # zero weights: run to max_frames deterministically
        dtype=dtype,
        # deliver each tick's audio the moment the device finishes it
        # (~1 tick less TTFB than the sync one-tick pipeline)
        async_harvest=True,
        max_inflight_ticks=int(os.environ.get("BENCH_INFLIGHT", "1")),
    )
    return TTSEngine(params, cfg, voc_params, voc, ecfg, device=device), cfg


def probe_throughput(eng, cfg, seconds: float, utter_frames: int) -> float:
    """Aggregate audio-sec/wall-sec with slots kept full (upper bound)."""
    rng = np.random.default_rng(42)
    B = eng.ecfg.batch_slots
    samples = [0]

    def start_one():
        ids = rng.integers(2, cfg.vocab_size,
                           size=int(rng.integers(16, 48))).astype(np.int32)
        spk = rng.standard_normal(cfg.speaker_embedding_dim).astype(np.float32)
        eng.start_session(
            ids, spk,
            lambda a: samples.__setitem__(0, samples[0] + (len(a) if a is not None else 0)),
            max_frames=utter_frames)

    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        # keep queued+active at the slot count (joins are deferred+batched,
        # so pending entries are in-flight work, not overload)
        while eng.n_active + len(eng._pending) < B:
            start_one()
        eng.step()
    while eng.step():
        pass
    wall = time.monotonic() - t0
    return samples[0] / eng.ecfg.sample_rate / wall


def main() -> None:
    from ..utils.metrics import metrics
    from ..utils.platform import card_info, default_device
    from .paced_calls import PacedCallConfig, run_paced

    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    B = int(os.environ.get("BENCH_SLOTS", "24"))
    utter_frames = int(os.environ.get("BENCH_UTTER", "96"))  # ~1.5 s audio
    duty = 0.5  # LT calls: TTS speaks <= half the time
    # Fixed 32-frame ticks: under continuous utterance churn an adaptive
    # (8,...,32) schedule degenerates to all-8-frame ticks for every slot,
    # and the per-tick host cost then dominates.
    eng, cfg = build_engine(dev, B, chunk_schedule=(32,),
                            max_steps=utter_frames // 2 + 32,
                            int8=bool(os.environ.get("BENCH_INT8")))
    device_detail = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                else str(dev)),
                     "card": card_info() if dev.type == "cuda" else None}

    # -- warmup: first launches of every join and chunk size ------------------
    t_warm = time.monotonic()
    eng.warmup()
    warmup_s = time.monotonic() - t_warm

    # -- probe aggregate throughput (sets the candidate ladder) ---------------
    T = probe_throughput(eng, cfg, seconds=8.0, utter_frames=utter_frames)

    if os.environ.get("BENCH_MODE") == "streams":
        print(json.dumps({
            "metric": "tts_concurrent_realtime_streams_per_chip",
            "value": round(T, 2),
            "unit": "streams (16kHz audio-sec/wall-sec)",
            "detail": {**device_detail, "batch_slots": B,
                       "warmup_s": round(warmup_s, 1)},
        }))
        eng.close()
        return

    # -- ramp paced calls until the SLA breaks ---------------------------------
    ceiling = T / duty  # service capacity in calls at this duty cycle
    measure_s = float(os.environ.get("BENCH_SECONDS", "20"))
    base = PacedCallConfig(utterance_frames=utter_frames, duty=duty,
                           sla_ttfb_s=0.2, measure_s=measure_s, seed=42)
    best = None
    levels = []

    def run_level(n: int):
        r = run_paced(eng, dataclasses.replace(base, n_calls=n))
        snap = metrics.snapshot()
        levels.append({
            "n_calls": r.n_calls, "ttfb_p50_s": round(r.ttfb_p50, 3),
            "ttfb_p95_s": round(r.ttfb_p95, 3), "underruns": r.underruns,
            "utterances": r.utterances,
            "streams_equiv": round(r.audio_s / r.wall_s, 1),
            "tick_p50_s": round(snap.get("tts.tick_s.p50", 0.0), 4),
            "tick_p95_s": round(snap.get("tts.tick_s.p95", 0.0), 4),
            "ok": r.ok,
        })
        return r

    # ramp up from 60% of the probe ceiling, one retry per failed level
    # (host clocks vary between runs); if even that fails, back off so a
    # slow run still reports the level it CAN serve
    failed_at = None
    for f in (0.6, 0.75, 0.9, 0.95, 1.0):
        n = max(1, int(ceiling * f))
        r = run_level(n)
        if not r.ok:
            r = run_level(n)
        if r.ok:
            best = r
        else:
            failed_at = n
            break
    if best is not None and failed_at is not None:
        # refine the capacity boundary once at the midpoint
        mid = (best.n_calls + failed_at) // 2
        if mid > best.n_calls + 2:
            r = run_level(mid)
            if r.ok:
                best = r
    if best is None:
        for f in (0.45, 0.3, 0.15):
            r = run_level(max(1, int(ceiling * f)))
            if r.ok:
                best = r
                break
        if best is not None and failed_at is not None:
            # climb back toward the failed level once
            mid = (best.n_calls + failed_at) // 2
            if mid > best.n_calls + 2:
                r = run_level(mid)
                if r.ok:
                    best = r
    eng.close()

    value = best.n_calls if best else 0
    print(json.dumps({
        "metric": "tts_paced_concurrent_calls_per_chip",
        "value": value,
        "unit": "paced 1x-realtime calls (p95 TTFB<200ms, 0 underruns, duty 0.5)",
        "detail": {
            **device_detail,
            "batch_slots": B,
            "int8": bool(os.environ.get("BENCH_INT8")),
            "utterance_frames": utter_frames,
            "duty": duty,
            "throughput_streams_probe": round(T, 1),
            "levels": levels,
            "best_ttfb_p95_s": round(best.ttfb_p95, 3) if best else None,
            "best_ttfb_p50_s": round(best.ttfb_p50, 3) if best else None,
            "warmup_s": round(warmup_s, 1),
        },
    }))


if __name__ == "__main__":
    main()
