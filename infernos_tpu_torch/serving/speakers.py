"""Speaker-embedding bank for TTS voices (port of
``infernos_tpu/serving/speakers.py``): a deterministic synthetic bank of
unit-norm vectors until real x-vectors are vendored."""

from __future__ import annotations

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

    def __len__(self) -> int:
        return len(self.vectors)

    def get(self, idx: int) -> np.ndarray:
        return self.vectors[idx % len(self.vectors)]

    def rand_id(self) -> int:
        return int(self._rng.integers(0, len(self.vectors)))
