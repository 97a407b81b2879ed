"""Streaming TTS demo: speak sentences concurrently, write WAVs, print timing.

Port of ``examples/tts_stream.py`` (the single-file equivalent of the
reference's ``HelloSippyTTSRT/HelloSippyRTPipeTest.py`` demo loop).

Run: python -m infernos_tpu_torch.examples.tts_stream "text to speak" [--full] [--out DIR]

What differs, and why:

- It runs on the card in bf16 (every decoder step through the step
  kernel), or on the CPU in fp32 when ``INFERNOS_DEVICE=cpu`` asks for it;
  without a card it raises.  On the card it takes ``--full`` only: the
  tiny dims are not ones the decoder-step kernel takes.
- The weights come from ``torch.Generator``s seeded with two seeds drawn
  from a generator seeded 42 (the reference splits ``PRNGKey(42)``).
- ``main`` returns the WAV paths it wrote, one per text.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

DEFAULT_TEXTS = ["Hello from the TPU native framework.",
                 "This stream renders twenty millisecond chunks."]


def main(argv: Optional[List[str]] = None) -> List[str]:
    import numpy as np
    import torch

    from ..audio.chunk import AudioChunk
    from ..models import hifigan as hfg
    from ..models import presets
    from ..models import speecht5 as st5
    from ..models.tiny_real import serving_dtype
    from ..models.tokenizers import CharTokenizer
    from ..serving.speakers import SpeakerBank
    from ..serving.tts_engine import TTSEngine, TTSEngineConfig
    from ..utils.platform import default_device

    argv = list(sys.argv[1:] if argv is None else argv)
    tiny = "--full" not in argv
    out_dir = "."
    if "--out" in argv:
        i = argv.index("--out")
        out_dir = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    texts = [a for a in argv if not a.startswith("--")] or DEFAULT_TEXTS

    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    if dev.type == "cuda" and tiny:
        raise SystemExit("tts_stream: on the card it serves --full: the tiny dims "
                         "are not ones the decoder-step kernel takes")
    dtype = serving_dtype(dev, tiny=tiny)
    cfg = presets.SPEECHT5_TINY if tiny else presets.SPEECHT5_FULL
    voc = presets.HIFIGAN_TINY if tiny else presets.HIFIGAN_FULL
    k1, k2 = torch.randint(2**62, (2,), generator=torch.Generator().manual_seed(42)).tolist()
    eng = TTSEngine(
        st5.init_params(cfg, torch.Generator(device=dev).manual_seed(k1), dev, dtype), cfg,
        hfg.init_params(voc, torch.Generator(device=dev).manual_seed(k2), dev, dtype), voc,
        TTSEngineConfig(batch_slots=min(8, len(texts) + 1),
                        max_steps=128, chunk_schedule=(8, 16, 32),
                        stop_threshold=2.0, dtype=dtype),
        device=dev)
    print(f"device={dev} tiny={tiny}; warming up...")
    eng.warmup()

    tok = CharTokenizer()
    bank = SpeakerBank.synthetic(dim=cfg.speaker_embedding_dim)
    sr = eng.ecfg.sample_rate
    state, written = {}, []

    for i, text in enumerate(texts):
        state[i] = {"t0": time.monotonic(), "first": None, "chunks": []}

        def cb(audio, i=i):
            s = state[i]
            if audio is None:
                wall = time.monotonic() - s["t0"]
                total = np.concatenate(s["chunks"]) if s["chunks"] else np.zeros(0)
                path = os.path.join(out_dir, f"out_{i}.wav")
                AudioChunk(total, sr).save_wav(path)
                written.append(path)
                print(f"[{i}] ttfb={s['first'] - s['t0']:.3f}s "
                      f"total={wall:.2f}s audio={len(total) / sr:.2f}s "
                      f"rtr={len(total) / sr / wall:.2f} -> out_{i}.wav")
                return
            if s["first"] is None:
                s["first"] = time.monotonic()
            s["chunks"].append(audio)

        eng.start_session(tok(text), bank.get(i * 7), cb, max_frames=96)

    while eng.step():
        pass
    eng.close()
    return written


if __name__ == "__main__":
    main()
