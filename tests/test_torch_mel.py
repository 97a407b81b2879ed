"""Port's batched torch ``log_mel`` vs the reference ``log_mel_np``.

The reference takes its FFT in float64 (numpy promotes), the port in
float32; after the log10 and the (x + 4) / 4 scaling the two agree to 1e-4.
"""

import numpy as np
import pytest
import torch

from infernos_tpu.audio.mel import log_mel_np, mel_filterbank as np_filterbank
from infernos_tpu_torch.audio.mel import log_mel, mel_filterbank


@pytest.mark.parametrize("n_mels,n", [(80, 16000), (128, 8000 + 37)])
def test_log_mel_matches_numpy_reference(n_mels, n):
    rng = np.random.default_rng(n_mels)
    t = np.arange(n) / 16000.0
    wav = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                    0.1 * rng.standard_normal(n)]).astype(np.float32)
    want = log_mel_np(wav, n_mels=n_mels)
    got = log_mel(torch.from_numpy(wav), n_mels=n_mels).numpy()
    assert got.shape == want.shape == (2, n_mels, n // 160)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_filterbank_identical():
    np.testing.assert_array_equal(mel_filterbank(128), np_filterbank(128))


def test_silence_and_single_waveform():
    want = log_mel_np(np.zeros(3200, np.float32), n_mels=80)
    got = log_mel(torch.zeros(3200), n_mels=80).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
