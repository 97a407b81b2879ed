"""Post-retrain gate: the tiny-real pair handles both lexicon sides.

Port of ``tools/check_bilingual.py``, run through the port's engines on the
card (``--device cpu`` for the plain path):

    python -m infernos_tpu_torch.tools.check_bilingual [--device cpu]

It serves the checkpoints ``models/tiny_real`` finds (the vendored ones,
or a retrain's through ``INFERNOS_TINY_DATA_TINY_STT`` and
``INFERNOS_TINY_DATA_TINY_TTS``) and reports per language side (a) the STT
word accuracy on rendered speech and (b) the TTS -> STT loopback word
accuracy on the pt side (the Live Translator's far-leg round trip).  It
exits 1 unless each is at least 80%: the gate a retrain must pass before
its checkpoints are kept.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np

from .train_tiny_stt import word_acc

GATE = 0.8


def corpora(rng: np.random.Generator, n: int = 12) -> Dict[str, List[str]]:
    """``n`` texts of 2-4 lexicon words per side (pt: the en draw translated)."""
    from ..t2t.lexicon import EN_PT

    en_words = sorted(EN_PT)
    return {
        "en": [" ".join(rng.choice(en_words, size=rng.integers(2, 5))) for _ in range(n)],
        "pt": [" ".join(EN_PT[w] for w in rng.choice(en_words, size=rng.integers(2, 5)))
               for _ in range(n)],
    }


def transcribe(eng, tok, audios, lang: str) -> List[str]:
    from ..serving.stt_engine import STTRequest

    out = {}
    for i, audio in enumerate(audios):
        eng.submit(STTRequest(audio=audio, lang=lang,
                              text_cb=(lambda i: lambda r: out.__setitem__(i, r))(i)))
    for _ in range(200):
        if not eng.step():
            break
    return [tok.decode(out[i].tokens).strip() if i in out else ""
            for i in range(len(audios))]


def say(teng, ttok, text: str, speaker) -> np.ndarray:
    chunks, done = [], []
    teng.start_session(np.asarray(ttok(text), np.int32), speaker,
                       lambda a: done.append(1) if a is None else chunks.append(a))
    for _ in range(200):
        teng.step()
        if done:
            break
    return (np.concatenate(chunks).astype(np.float32) if chunks
            else np.zeros(1600, np.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu for the plain path")
    a = ap.parse_args(argv)

    from ..audio.speechlang import Speaker, render_text
    from ..models import tiny_real
    from ..serving.stt_engine import STTEngine
    from ..utils.platform import default_device

    device = default_device(a.device)
    params, cfg, tok, ecfg = tiny_real.load_tiny_stt(device)
    eng = STTEngine(params, cfg, ecfg, device=device)
    rng = np.random.default_rng(123)
    texts_by_side = corpora(rng)

    failed = False
    for side, texts in texts_by_side.items():
        audios = [render_text(rng, t, Speaker.random(rng)) for t in texts]
        hyps = transcribe(eng, tok, audios, side)
        acc = word_acc(hyps, texts)
        print(f"STT {side}-side word acc: {acc:.2%}")
        for r, h in list(zip(texts, hyps))[:3]:
            print(f"  ref {r!r} hyp {h!r}")
        failed |= acc < GATE

    if tiny_real.have_tiny_tts():
        from ..serving.tts_engine import TTSEngine, TTSEngineConfig

        tparams, tcfg, vparams, vcfg, ttok, table = tiny_real.load_tiny_tts(device=device)
        # the engine runs in the loaded trees' dtype (fp32, the tiny rule)
        teng = TTSEngine(tparams, tcfg, vparams, vcfg,
                         TTSEngineConfig(batch_slots=4, max_text_tokens=48,
                                         max_steps=170, stop_threshold=0.5,
                                         dtype=tiny_real.serving_dtype(device, tiny=True)),
                         device=device)
        texts = texts_by_side["pt"][:6]
        hyps = [transcribe(eng, tok, [say(teng, ttok, t, table[0])], "pt")[0]
                for t in texts]
        acc = word_acc(hyps, texts)
        print(f"TTS->STT pt-side loopback word acc: {acc:.2%}")
        for r, h in list(zip(texts, hyps))[:3]:
            print(f"  ref {r!r} hyp {h!r}")
        failed |= acc < GATE

    print("BILINGUAL CHECK", "FAILED" if failed else "PASSED")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
