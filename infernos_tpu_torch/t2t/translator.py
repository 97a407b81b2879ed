"""Text-to-text translation with pivot-language chaining.

Capability parity: the reference translates via argos models with automatic
pivot chaining when no direct pair exists (``Core/T2T/Translator.py:19-56``)
and caches Translator objects process-wide (``config/InfernGlobals.py:28-31``).

The translation backend is **pluggable**: the production backend is the
Qwen-class LLM engine that also serves the AIAttendant (one prompt per
sentence; no separate translation model on the device).  An ``EchoBackend`` keeps offline tests deterministic.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

SUPPORTED_LANGS = ["en", "it", "de", "ru", "ja", "pt", "es", "fr"]


class EchoBackend:
    """Deterministic no-op backend: tags text with the language pair.

    Stands in for a real model offline; the tag makes data flow visible in
    end-to-end tests.
    """

    def pairs(self) -> List[Tuple[str, str]]:
        return [(a, b) for a in SUPPORTED_LANGS for b in SUPPORTED_LANGS if a != b]

    def translate(self, text: str, from_code: str, to_code: str) -> str:
        return text if from_code == to_code else f"[{from_code}->{to_code}] {text}"


class LLMBackend:
    """Translate through the LLM engine with a fixed instruction prompt."""

    PROMPT = ("Translate the following text from {src} to {dst}. "
              "Reply with ONLY the translation.\n\n{text}")

    def __init__(self, complete: Callable[[str], str],
                 langs: Optional[List[str]] = None):
        self.complete = complete
        self.langs = langs or SUPPORTED_LANGS

    def pairs(self) -> List[Tuple[str, str]]:
        return [(a, b) for a in self.langs for b in self.langs if a != b]

    def translate(self, text: str, from_code: str, to_code: str) -> str:
        return self.complete(
            self.PROMPT.format(src=from_code, dst=to_code, text=text)
        ).strip()


def llm_backend_from_actor(llm_actr, langs: Optional[List[str]] = None,
                           timeout: float = 60.0) -> LLMBackend:
    """Production glue: an :class:`LLMBackend` whose completions run through
    a live ``LLMActor``.  Each translation uses a fresh one-shot session
    (translations are stateless; sharing chat context across unrelated
    sentences would leak content between them)."""

    def complete(prompt: str) -> str:
        done = threading.Event()
        parts: List[str] = []

        def cb(res) -> None:
            if res.text:
                parts.append(res.text)
            if res.is_final:
                done.set()

        sid = llm_actr.ask_sync("new_llm_session", "")
        try:
            llm_actr.call("llm_session_textin", sid, prompt, cb)
            if not done.wait(timeout):
                raise TimeoutError("LLM translation timed out")
        finally:
            llm_actr.call("llm_session_end", sid)
        return " ".join(parts)

    return LLMBackend(complete, langs=langs)


class Translator:
    """Direct or pivot-chained translation callable for one language pair."""

    def __init__(self, from_code: str, to_code: str, backend=None,
                 filter: Optional[Callable] = None,
                 supported_langs: Optional[List[str]] = None):
        self.backend = backend or EchoBackend()
        self.from_code, self.to_code = from_code, to_code
        langs = supported_langs or SUPPORTED_LANGS
        avail = set(self.backend.pairs())
        if (from_code, to_code) in avail:
            chain = [to_code]
        else:
            chain = None
            for pivot in langs:
                if pivot in (from_code, to_code):
                    continue
                if (from_code, pivot) in avail and (pivot, to_code) in avail:
                    chain = [pivot, to_code]
                    break
            if chain is None:
                raise ValueError(f"no translation path {from_code}->{to_code}")
        steps = []
        src = from_code
        for dst in chain:
            fn = (lambda t, s=src, d=dst: self.backend.translate(t, s, d))
            if filter is not None:
                fn = (lambda t, f=fn, s=src, d=dst: filter(t, from_code=s, to_code=d, tr=f))
            steps.append(fn)
            src = dst
        self.steps = steps

    def translate(self, text: str) -> str:
        for step in self.steps:
            text = step(text)
        return text


_cache_lock = threading.Lock()
_cache: Dict[Tuple, Translator] = {}


def get_translator(from_code: str, to_code: str, backend=None) -> Translator:
    """Process-wide cached translators (reference ``InfernGlobals.get_translator``)."""
    key = (from_code, to_code, id(backend) if backend is not None else None)
    with _cache_lock:
        tr = _cache.get(key)
        if tr is None:
            tr = _cache[key] = Translator(from_code, to_code, backend=backend)
        return tr
