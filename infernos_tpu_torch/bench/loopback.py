"""Loopback QA: TTS speaks a prompt, STT transcribes it, similarity scores
each speaker voice -- a self-contained integration test needing no human
listener.

Capability parity with ``Cluster/InfernBenchActor.py:34-60,205-331``: the
reference feeds TTS output through a ``SoundPreBatcher`` into STT and scores
prompt-vs-transcript with BERT-embedding cosine similarity per speaker,
checkpointing results per speaker across generations.  Here:

- audio flows TTS engine -> (16 kHz) -> STT engine;
- similarity is pluggable: default is a character-level ratio (works
  offline); pass an embedding callback for BERT-class scoring with real
  checkpoints;
- per-speaker scores persist as JSON for resumable generational runs.

Port of ``infernos_tpu/bench/loopback.py``.  ``LoopbackQA`` is the
reference's, on the port's engines.  ``main`` serves the tiny-real pair
through the port's loaders in fp32, on the card (or on the CPU when
``INFERNOS_DEVICE=cpu`` asks for it); without a card, or without the
vendored pair, it raises.  Its prompts come from the port's copy of the
speech language's corpus (``audio/speechlang.py``).
"""

from __future__ import annotations

import difflib
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class SpeakerScore:
    speaker_id: int
    similarity: float
    prompt: str
    transcript: str
    audio_s: float


def text_similarity(a: str, b: str) -> float:
    """Default offline similarity (the reference uses BERT cosine)."""
    return difflib.SequenceMatcher(None, a.lower(), b.lower()).ratio()


class LoopbackQA:
    def __init__(self, tts_engine, stt_engine, tokenize, detokenize=None,
                 similarity: Callable[[str, str], float] = text_similarity,
                 checkpoint_path: Optional[str] = None,
                 fingerprint: Optional[str] = None):
        self.tts = tts_engine
        self.stt = stt_engine
        self.tokenize = tokenize
        self.detok = detokenize
        self.similarity = similarity
        self.checkpoint_path = checkpoint_path
        # resume cells are only valid for the (model weights, prompt set)
        # they were scored against; a fingerprint mismatch discards them
        # (a re-run after new checkpoints would otherwise report the old
        # model's QA)
        self.fingerprint = fingerprint
        self.scores: Dict[int, float] = {}
        if checkpoint_path and os.path.exists(checkpoint_path):
            loaded = self._load_checkpoint()
            # "sid" keys: per-voice scores; "sid:pidx" cell keys belong
            # to run_bank sweeps and are reloaded there
            self.scores = {int(k): v for k, v in loaded.items()
                           if ":" not in str(k)}

    def _load_checkpoint(self) -> Dict[str, float]:
        with open(self.checkpoint_path) as f:
            loaded = json.load(f)
        saved_fp = loaded.pop("__fingerprint__", None)
        if self.fingerprint is not None and saved_fp != self.fingerprint:
            return {}
        return loaded

    def _save_checkpoint(self, cells: Dict[str, float]) -> None:
        out = dict(cells)
        if self.fingerprint is not None:
            out["__fingerprint__"] = self.fingerprint
        with open(self.checkpoint_path, "w") as f:
            json.dump(out, f)

    def _speak(self, prompt: str, speaker,
               max_frames: Optional[int] = None) -> np.ndarray:
        """Synthesize ``prompt``; the trained stop token ends the utterance
        (no artificial frame cap by default -- a cap below the model's
        natural length truncates long prompts MID-WORD and reads as an STT
        quality failure)."""
        chunks: List[np.ndarray] = []
        done = []
        self.tts.start_session(self.tokenize(prompt), speaker,
                               lambda a: done.append(1) if a is None
                               else chunks.append(a),
                               max_frames=max_frames)
        while self.tts.step():
            pass
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def _transcribe(self, audio: np.ndarray, lang: str = "en") -> str:
        from ..serving.stt_engine import STTRequest

        out: List = []
        self.stt.submit(STTRequest(audio=audio, text_cb=out.append, lang=lang))
        while self.stt.step():
            pass
        return out[0].text if out else ""

    def score_speaker(self, speaker_id: int, speaker_vec, prompt: str,
                      lang: str = "en") -> SpeakerScore:
        """Score one (voice, prompt) round trip.  ``lang`` conditions the
        STT decode -- serving legs are language-pure, so QA prompts must be
        too (an en-conditioned decode of pt words snaps them to en
        spellings on the language-conditioned checkpoints)."""
        audio = self._speak(prompt, speaker_vec)
        # TTS engine emits at its sample_rate; STT expects 16 kHz
        sr = self.tts.ecfg.sample_rate
        if sr != 16000:
            from ..audio.chunk import AudioChunk

            audio = AudioChunk(audio, sr).resample(16000).audio
        transcript = self._transcribe(audio, lang=lang)
        sim = self.similarity(prompt, transcript)
        self.scores[speaker_id] = sim
        return SpeakerScore(speaker_id, sim, prompt, transcript,
                            len(audio) / 16000.0)

    @staticmethod
    def _norm(prompt) -> tuple:
        """Prompts are ``"text"`` (lang 'en') or ``(text, lang)``."""
        return prompt if isinstance(prompt, tuple) else (prompt, "en")

    def run_generation(self, bank, speaker_ids, prompts) -> List[SpeakerScore]:
        out = []
        for i, sid in enumerate(speaker_ids):
            text, lang = self._norm(prompts[i % len(prompts)])
            out.append(self.score_speaker(sid, bank.get(sid), text,
                                          lang=lang))
        if self.checkpoint_path:
            self._save_checkpoint({str(k): v for k, v in self.scores.items()})
        return out

    def run_bank(self, bank, speaker_ids, prompts,
                 on_voice_done: Optional[Callable] = None) -> Dict[int, List[SpeakerScore]]:
        """Score EVERY voice on EVERY prompt (the reference's whole-bank QA
        sweep, ``Cluster/InfernBenchActor.py:76-86,259-263``), resumable at
        (voice, prompt) granularity through ``checkpoint_path``.

        ``self.scores`` keeps the per-voice MEAN; the checkpoint holds the
        raw ``"sid:pidx" -> sim`` cells so an interrupted sweep resumes
        mid-voice.
        """
        cells: Dict[str, object] = {}
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            cells = {k: v for k, v in self._load_checkpoint().items()
                     if ":" in str(k)}
        per_voice: Dict[int, List[SpeakerScore]] = {}
        for sid in speaker_ids:
            rows: List[SpeakerScore] = []
            for pidx, prompt in enumerate(prompts):
                text, lang = self._norm(prompt)
                key = f"{sid}:{pidx}"
                if key in cells:
                    c = cells[key]
                    # dict cells carry the transcript through a resume;
                    # bare floats are older checkpoints' cells
                    if isinstance(c, dict):
                        rows.append(SpeakerScore(
                            sid, c["sim"], text, c.get("transcript", ""),
                            c.get("audio_s", 0.0)))
                    else:
                        rows.append(SpeakerScore(sid, c, text, "", 0.0))
                    continue
                s = self.score_speaker(sid, bank.get(sid), text, lang=lang)
                rows.append(s)
                cells[key] = {"sim": s.similarity, "transcript": s.transcript,
                              "audio_s": s.audio_s}
                if self.checkpoint_path:
                    self._save_checkpoint(cells)
            per_voice[sid] = rows
            self.scores[sid] = float(np.mean([r.similarity for r in rows]))
            if on_voice_done is not None:
                on_voice_done(sid, per_voice)
        return per_voice

    def top_speakers(self, n: int = 50) -> List[int]:
        return [sid for sid, _ in sorted(self.scores.items(),
                                         key=lambda kv: -kv[1])[:n]]


def loopback_prompts(n_prompts: int) -> List[tuple]:
    """``n_prompts`` language-pure ``(text, lang)`` prompts from the
    vocabulary the serving STT checkpoint was trained on: the first half
    (rounded up) English, the rest Portuguese (the language-conditioned
    STT decodes each request under one language token)."""
    from ..audio.speechlang import (EN_WORDS, PT_WORDS, checkpoint_words,
                                    transcript_corpus)

    ck = set(checkpoint_words("tiny_stt"))
    en_vocab = [w for w in EN_WORDS if w in ck]
    pt_vocab = [w for w in PT_WORDS if w in ck and w not in en_vocab]
    if pt_vocab:
        n_en = (n_prompts + 1) // 2
        return ([(t, "en") for t in transcript_corpus(n_en, seed=555,
                                                      words=en_vocab)]
                + [(t, "pt") for t in transcript_corpus(n_prompts - n_en,
                                                        seed=556,
                                                        words=pt_vocab)])
    # an en-only checkpoint
    return [(t, "en") for t in transcript_corpus(
        n_prompts, seed=555, words=en_vocab or sorted(ck))]


def tiny_real_engines(device):
    """The tiny-real TTS and STT engines the bench scores, on ``device``
    in its serving dtype, and the TTS tokenizer and speaker table."""
    from ..models import tiny_real
    from ..serving.stt_engine import STTEngine
    from ..serving.tts_engine import TTSEngine, TTSEngineConfig

    if not (tiny_real.have_tiny_stt() and tiny_real.have_tiny_tts()):
        raise RuntimeError("loopback: the vendored tiny-real STT/TTS pair "
                           "is not present")
    t5, tcfg, voc, vcfg, ttok, table = tiny_real.load_tiny_tts(device=device)
    sparams, scfg, stok, secfg = tiny_real.load_tiny_stt(device)
    tts = TTSEngine(t5, tcfg, voc, vcfg, TTSEngineConfig(
        batch_slots=4, max_text_tokens=48, max_steps=170,
        stop_threshold=0.5, dtype=tiny_real.serving_dtype(device, tiny=True)),
        device=device)
    stt = STTEngine(sparams, scfg, secfg, detokenize=stok.detokenize,
                    device=device)
    return tts, stt, ttok, table


def main(argv=None) -> None:
    """Loopback QA over the in-repo-trained tiny pair.

    Usage: python -m infernos_tpu_torch.bench.loopback [--speakers 8]
           [--prompts 2] [--checkpoint FILE]
    """
    import argparse
    import hashlib
    from pathlib import Path

    from ..models import tiny_real
    from ..utils.platform import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--speakers", type=int, default=8,
                    help="number of bank voices to sweep")
    ap.add_argument("--prompts", type=int, default=2,
                    help="prompts scored PER VOICE")
    ap.add_argument("--checkpoint", default=None,
                    help="resumable (voice,prompt)-cell score file")
    ap.add_argument("--cutoff", type=float, default=0.90,
                    help="per-voice QA cutoff (ref: max_error < 0.10, "
                         "Cluster/InfernBenchActor.py:259-263)")
    a = ap.parse_args(argv)
    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    tts, stt, ttok, table = tiny_real_engines(dev)
    prompts = loopback_prompts(a.prompts)

    h = hashlib.sha1(json.dumps(prompts).encode())
    for part in ("tiny_stt/params.npz", "tiny_tts/t5_params.npz"):
        p = Path(tiny_real.data_path(part.split("/")[0])) / part.split("/")[1]
        st = os.stat(p)
        h.update(f"{part}:{st.st_size}:{st.st_mtime_ns}".encode())
    qa = LoopbackQA(tts, stt, tokenize=ttok, checkpoint_path=a.checkpoint,
                    fingerprint=h.hexdigest())

    class _Bank:
        def get(self, sid):
            return table[sid % len(table)]

    n_voices = min(a.speakers, len(table)) if a.speakers else len(table)

    def report(per_voice):
        voice_means = {sid: float(np.mean([r.similarity for r in rows]))
                       for sid, rows in per_voice.items()}
        means = np.array(sorted(voice_means.values()))
        worst = min(voice_means, key=voice_means.get)
        below = sorted(sid for sid, m in voice_means.items()
                       if m < a.cutoff)
        return {
            "metric": "loopback_similarity",
            "value": round(float(means.mean()), 3),
            "unit": "char-level prompt<->transcript similarity (ref: BERT "
                    "cosine, Cluster/InfernBenchActor.py:76-86)",
            "detail": {
                "voices_scored": len(voice_means),
                "prompts_per_voice": len(prompts),
                "per_voice_mean_distribution": {
                    "min": round(float(means[0]), 3),
                    "p10": round(float(np.percentile(means, 10)), 3),
                    "median": round(float(np.median(means)), 3),
                    "p90": round(float(np.percentile(means, 90)), 3),
                    "max": round(float(means[-1]), 3),
                },
                "worst_voice": {"speaker": worst,
                                "sim": round(voice_means[worst], 3)},
                "cutoff": a.cutoff,
                "voices_below_cutoff": below,
                "frac_passing_cutoff": round(
                    float(np.mean(means >= a.cutoff)), 3),
            },
        }

    def on_voice_done(sid, per_voice):
        # one parseable line per completed voice: an interrupted sweep
        # still leaves the caller the freshest complete aggregate
        print(json.dumps(report(per_voice)), flush=True)

    per_voice = qa.run_bank(_Bank(), list(range(n_voices)), prompts,
                            on_voice_done=on_voice_done)
    out = report(per_voice)
    samples = [r for rows in per_voice.values() for r in rows
               if r.transcript][:4]
    out["detail"]["samples"] = [
        {"speaker": s.speaker_id, "sim": round(s.similarity, 3),
         "prompt": s.prompt, "transcript": s.transcript} for s in samples]
    out["detail"]["device"] = str(dev)
    print(json.dumps(out))
    tts.close()


if __name__ == "__main__":
    main()
