"""Offline tokenizers (port of ``infernos_tpu/models/tokenizers.py``).

Deterministic text <-> id maps for every pipeline stage without downloads;
``HFTokenizerAdapter`` wraps a transformers tokenizer (the caller's object:
this module imports no transformers) with the same interface.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class CharTokenizer:
    """Char-level tokenizer in the spirit of SpeechT5's 81-token vocab."""

    def __init__(self, extra: str = ""):
        alphabet = " abcdefghijklmnopqrstuvwxyz'.,?!-0123456789" + extra
        # ids 0..3 reserved: pad=1 matches SpeechT5Config.pad_token_id
        self.char_to_id = {c: i + 4 for i, c in enumerate(alphabet)}
        self.vocab_size = 4 + len(alphabet)
        self.unk_id = 3

    def __call__(self, text: str) -> np.ndarray:
        ids = [self.char_to_id.get(c, self.unk_id) for c in text.lower()]
        return np.asarray(ids, np.int32)


class ByteTokenizer:
    """Reversible UTF-8 byte tokenizer for offline LLM flows.

    ids: 0..255 = bytes + offset 3 (0=pad, 1=bos, 2=eos); vocab 259+.
    """

    OFFSET = 3
    vocab_size = 259

    def __call__(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32) + self.OFFSET

    def detokenize(self, ids: Sequence[int]) -> str:
        bs = bytes(max(0, min(255, t - self.OFFSET)) for t in ids
                   if t >= self.OFFSET)
        return bs.decode("utf-8", "replace")


class HFTokenizerAdapter:
    """Wrap a transformers tokenizer into (tokenize, detokenize) callables."""

    def __init__(self, tok):
        self.tok = tok
        self.vocab_size = tok.vocab_size

    def __call__(self, text: str) -> np.ndarray:
        return np.asarray(self.tok(text, add_special_tokens=False)["input_ids"],
                          np.int32)

    def detokenize(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(path: str, special_tokens=None):
    """Load a ported tokenizer directory with zero network.

    ``vocab.json`` + ``merges.txt`` -> the byte-level BPE engine
    (``models/bpe.py``; Whisper/Qwen/GPT-2 family); ``spiece.model`` -> the
    SentencePiece unigram reader (``models/spm.py``; SpeechT5).  Raises
    FileNotFoundError when neither layout is present.
    """
    import os

    from .bpe import ByteLevelBPE
    from .spm import load_spm_model

    vj = os.path.join(path, "vocab.json")
    mt = os.path.join(path, "merges.txt")
    if os.path.exists(vj) and os.path.exists(mt):
        return ByteLevelBPE.from_files(vj, mt, special_tokens=special_tokens)
    sp = os.path.join(path, "spiece.model")
    if os.path.exists(sp):
        return load_spm_model(sp)
    raise FileNotFoundError(
        f"no tokenizer files (vocab.json+merges.txt or spiece.model) in {path}")
