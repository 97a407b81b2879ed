"""Probe: TTS tick time through the decoder-step kernel at a serving width.

Fills every slot of a full-width SpeechT5 + HiFi-GAN engine (zero weights:
the values do not change the work) and times ``step()`` over ``--ticks``
steady-state ticks of 32 frames.

  python -m infernos_tpu_torch.bench.ttsprobe [--slots 24] [--ticks 60]
      [--frames 96]

Prints one JSON line, ``{"fused": {"tick_p50_ms", "tick_p95_ms",
"compile_s"}}``.

Port of ``infernos_tpu/bench/ttsprobe.py``, which times the Pallas step
against XLA's.  The port has one path on the card, the kernel (the plain
PyTorch step runs on CPU tensors only), so it measures the kernel path
alone: ``--only xla`` and ``--only both`` are refused, not mapped to it.
``chip_smoke.py`` holds the kernel against its plain version.  It runs on
the card, or on the CPU when ``INFERNOS_DEVICE=cpu`` asks for it; without
a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def run_mode(B: int, ticks: int, frames: int, device=None, tiny: bool = False):
    """Steady-state tick times of a ``B``-slot engine kept full, at full
    SpeechT5 + HiFi-GAN width (``tiny``: the test dims) on ``device``."""
    from ..cluster.model_actors import zeros_init
    from ..models import hifigan as hfg
    from ..models import presets
    from ..models import speecht5 as st5
    from ..models.tiny_real import serving_dtype
    from ..serving.tts_engine import TTSEngine, TTSEngineConfig
    from ..utils.platform import default_device

    dev = default_device(device)
    # both dims are bf16 on the reference's TPU (infernos_tpu/bench/ttsprobe.py)
    dtype = serving_dtype(dev, tiny=False)
    cfg = presets.SPEECHT5_TINY if tiny else presets.SPEECHT5_FULL
    voc = presets.HIFIGAN_TINY if tiny else presets.HIFIGAN_FULL
    params = zeros_init(lambda g, d, t: st5.init_params(cfg, g, d, t), dev, dtype)
    voc_params = zeros_init(lambda g, d, t: hfg.init_params(voc, g, d, t), dev, dtype)
    ecfg = TTSEngineConfig(
        batch_slots=B, max_text_tokens=64, max_steps=frames // 2 + 64,
        chunk_schedule=(32,), min_steps=8, stop_threshold=2.0, dtype=dtype)
    eng = TTSEngine(params, cfg, voc_params, voc, ecfg, device=dev)

    rng = np.random.default_rng(0)
    sink = lambda a: None

    def fill():
        while eng.n_active + len(eng._pending) < B:
            ids = rng.integers(2, cfg.vocab_size, size=32).astype(np.int32)
            spk = rng.standard_normal(cfg.speaker_embedding_dim).astype(
                np.float32)
            eng.start_session(ids, spk, sink, max_frames=frames)

    t0 = time.monotonic()
    fill()
    eng.step()  # first launches (allocator, cuDNN)
    compile_s = time.monotonic() - t0
    # steady state
    times = []
    for _ in range(ticks):
        fill()
        t = time.monotonic()
        eng.step()
        times.append(time.monotonic() - t)
    while eng.step():
        pass
    times.sort()
    p50 = times[len(times) // 2]
    p95 = times[int(0.95 * len(times))]
    return {"tick_p50_ms": round(p50 * 1e3, 2),
            "tick_p95_ms": round(p95 * 1e3, 2),
            "compile_s": round(compile_s, 1)}


def main(argv=None) -> None:
    from ..utils.platform import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=24)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--only", choices=["fused", "xla", "both"],
                    default="fused")
    a = ap.parse_args(argv)
    if a.only != "fused":
        ap.error(f"--only {a.only}: the port has no plain step on the card "
                 "(its plain PyTorch version runs on CPU tensors only); "
                 "this probe times the kernel path, --only fused")
    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    out = {"fused": run_mode(a.slots, a.ticks, a.frames, device=dev)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
