"""Offline tokenizers (port of ``infernos_tpu/models/tokenizers.py``)."""

from __future__ import annotations

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
