"""Speaker-embedding bank for TTS voices (port of
``infernos_tpu/serving/speakers.py``): an ``.npz`` bank of x-vectors when
one is on disk, else a deterministic synthetic bank of unit-norm vectors.

The reference's ``load_hf_xvectors`` downloads the CMU-Arctic bank from
the Hub; it is not ported until the bank's file is in the repository.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

DEFAULT_N_SPEAKERS = 7931  # CMU-Arctic x-vector count of the upstream bank


class SpeakerBank:
    def __init__(self, vectors: np.ndarray):
        if vectors.ndim != 2:
            raise ValueError("speaker bank must be [n, dim]")
        self.vectors = vectors.astype(np.float32)
        self._rng = np.random.default_rng(0)

    @classmethod
    def synthetic(cls, dim: int = 512, n: int = DEFAULT_N_SPEAKERS,
                  seed: int = 42) -> "SpeakerBank":
        rng = np.random.default_rng(seed)
        v = rng.standard_normal((n, dim)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return cls(v)

    @classmethod
    def from_npz(cls, path: str) -> "SpeakerBank":
        """The ``xvectors`` array of an ``.npz`` file."""
        return cls(np.load(path)["xvectors"])

    @classmethod
    def load(cls, path: Optional[str] = None, dim: int = 512) -> "SpeakerBank":
        """The bank at ``path`` when it exists, else the synthetic one."""
        if path and os.path.exists(path):
            return cls.from_npz(path)
        return cls.synthetic(dim=dim)

    def __len__(self) -> int:
        return len(self.vectors)

    def get(self, idx: int) -> np.ndarray:
        return self.vectors[idx % len(self.vectors)]

    def rand_id(self) -> int:
        return int(self._rng.integers(0, len(self.vectors)))

    def top_speakers(self, lang: str, n: int = 50) -> List[int]:
        """Curated voices per language: a sample keyed by the language, as
        the reference draws it until loopback QA ranks real voices.  Its
        seed is ``hash(lang)``, which Python salts per process unless
        ``PYTHONHASHSEED`` is set: the list is stable within one process
        only, as the reference's is."""
        rng = np.random.default_rng(abs(hash(lang)) % (2**32))
        return list(rng.choice(len(self.vectors), size=min(n, len(self.vectors)),
                               replace=False))
