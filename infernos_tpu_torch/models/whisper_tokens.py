"""Vendored Whisper special-token tables (published constants).

Upstream Infernos reads these ids from the HF tokenizer at run time; this
package keeps the published layouts instead.  Two vocabularies exist:

- **v2** (multilingual, vocab 51865): whisper-large-v2 and earlier.
  99 language tokens at 50259..50357, then ``<|translate|>`` 50358,
  ``<|transcribe|>`` 50359, ``<|startoflm|>`` 50360, ``<|startofprev|>``
  50361, ``<|nospeech|>`` 50362, ``<|notimestamps|>`` 50363, timestamps
  ``<|0.00|>`` from 50364.
- **v3** (vocab 51866): whisper-large-v3(+turbo).  Adds ``yue`` as the
  100th language (50358), shifting every later special by +1:
  ``<|translate|>`` 50359, ``<|transcribe|>`` 50360, ``<|startoflm|>``
  50361, ``<|startofprev|>`` 50362, ``<|nospeech|>`` 50363,
  ``<|notimestamps|>`` 50364, timestamps from 50365 (3001 tokens,
  0.00..30.00 s in 20 ms increments, matching the RTP ptime grid).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Whisper's canonical language order (tokenizer LANGUAGES dict order);
# language token id = sot + 1 + index for both vocabularies.
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",  # yue exists only in v3
)

V2_VOCAB = 51865
V3_VOCAB = 51866

EOT = 50257  # <|endoftext|> (same in both vocabs)
SOT = 50258  # <|startoftranscript|>
LANG_BASE = 50259


@dataclasses.dataclass(frozen=True)
class WhisperSpecials:
    """Resolved special-token ids for one vocabulary."""

    vocab_size: int
    eot: int = EOT
    sot: int = SOT
    translate: int = 0
    transcribe: int = 0
    startoflm: int = 0
    startofprev: int = 0
    nospeech: int = 0
    notimestamps: int = 0
    timestamp_begin: int = 0
    n_langs: int = 99

    def lang_token(self, code: str) -> int:
        idx = LANGUAGES.index(code)
        if idx >= self.n_langs:
            raise KeyError(f"language {code!r} not in this vocabulary")
        return LANG_BASE + idx

    def timestamp_seconds(self, token_id: int) -> Optional[float]:
        """Token -> seconds if it is a timestamp token, else None."""
        if token_id >= self.timestamp_begin:
            return (token_id - self.timestamp_begin) * 0.02
        return None


SPECIALS_V2 = WhisperSpecials(
    vocab_size=V2_VOCAB, translate=50358, transcribe=50359, startoflm=50360,
    startofprev=50361, nospeech=50362, notimestamps=50363,
    timestamp_begin=50364, n_langs=99,
)
SPECIALS_V3 = WhisperSpecials(
    vocab_size=V3_VOCAB, translate=50359, transcribe=50360, startoflm=50361,
    startofprev=50362, nospeech=50363, notimestamps=50364,
    timestamp_begin=50365, n_langs=100,
)


def specials_for_vocab(vocab_size: int) -> WhisperSpecials:
    """Pick the special-token layout from the checkpoint's vocab size."""
    if vocab_size >= V3_VOCAB:
        return SPECIALS_V3
    return SPECIALS_V2


# Non-speech suppress set, vendored from openai/whisper-large-v3
# generation_config.json ``suppress_tokens`` (punctuation/music BPE ids plus
# the sot/task/lm/prev/nospeech specials).  Re-verify against the tokenizer
# whenever a real checkpoint is ported (tools/port_checkpoints.py does).
SUPPRESS_V3: Tuple[int, ...] = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254, 50258, 50359, 50360, 50361, 50362,
    50363,
)
# First-step suppressions (space and <|endoftext|>); same for v2/v3.
BEGIN_SUPPRESS: Tuple[int, ...] = (220, 50257)


def decode_with_timestamps(tokens: Sequence[int], detokenize,
                           specials: WhisperSpecials) -> str:
    """Detokenize, rendering timestamp tokens as ``<|s.ss|>`` markers.

    ``detokenize`` handles plain text ids; timestamp tokens are spliced in
    as readable markers (parity with the reference's ``timestamps`` request
    flag, ``Cluster/STTSession.py:17-20``).
    """
    out: list = []
    run: list = []
    for t in tokens:
        secs = specials.timestamp_seconds(t)
        if secs is None:
            run.append(t)
            continue
        if run:
            out.append(detokenize(run))
            run = []
        out.append(f"<|{secs:.2f}|>")
    if run:
        out.append(detokenize(run))
    return "".join(out)
