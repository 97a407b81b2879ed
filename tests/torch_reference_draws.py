"""The reference's TTS draws for the port's call tests.

The tiny-real TTS output is a sample: SpeechT5's prenet dropout stays on at
inference, in both packages, and Griffin-Lim starts from a drawn phase.
The port's draws (``torch.Generator``) cannot equal the reference's
(``jax.random``), and over twelve draws either package garbles a word of a
say now and then.  The :func:`reference_draws` fixture runs the port's TTS
engines on the reference's draws: each engine's prenet masks come from the
reference engine's key chain (a key per tick from its seed counter, split
per step and per prenet layer), and the Griffin-Lim phase from the
reference's fixed key.  Test files that drive a tiny-real call import it.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from infernos_tpu_torch.audio import griffinlim as gl
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.serving import tts_engine


class _ReferenceDraw:
    """Stands in for a port TTS engine's generator: the reference engine's
    prenet dropout draw (``infernos_tpu/serving/tts_engine.py``: the tick's
    key is ``PRNGKey(seed)`` with ``seed`` counted up before each dispatch
    from the engine's ``rng_seed`` 0, split once per step; the prenet
    splits it once per layer and draws ``bernoulli(p)`` keep masks)."""

    def __init__(self, cfg):
        self.cfg, self.seed, self.key = cfg, 0, None

    def new_tick(self):
        self.seed += 1
        self.key = jax.random.PRNGKey(np.uint32(self.seed))

    def masks(self, n_frames, device):
        self.key, sub = jax.random.split(self.key)
        out = []
        for _ in range(self.cfg.speech_decoder_prenet_layers):
            sub, k = jax.random.split(sub)
            m = jax.random.bernoulli(k, self.cfg.speech_decoder_prenet_dropout,
                                     (n_frames, self.cfg.speech_decoder_prenet_units))
            out.append(torch.from_numpy(np.array(m)).to(device))
        return out


def _reference_phase(shape, device):
    """The reference Griffin-Lim's starting phase, in place of the port's."""
    ph = jax.random.uniform(jax.random.PRNGKey(12345), tuple(shape), np.float32,
                            0.0, 2.0 * np.pi)
    return torch.from_numpy(np.array(ph)).to(device)


@pytest.fixture
def reference_draws():
    init, decode = tts_engine.TTSEngine.__init__, tts_engine.TTSEngine._decode_chunk
    draw_masks = st5.prenet_dropout_masks

    def engine_init(self, *a, **kw):
        init(self, *a, **kw)
        self._gen = _ReferenceDraw(self.cfg)

    def decode_chunk(self, paused, n_frames):
        self._gen.new_tick()
        return decode(self, paused, n_frames)

    def masks(cfg, n_frames, generator, device):
        if isinstance(generator, _ReferenceDraw):
            return generator.masks(n_frames, device)
        return draw_masks(cfg, n_frames, generator, device)

    with mock.patch.object(tts_engine.TTSEngine, "__init__", engine_init), \
            mock.patch.object(tts_engine.TTSEngine, "_decode_chunk", decode_chunk), \
            mock.patch.object(st5, "prenet_dropout_masks", masks), \
            mock.patch.object(gl, "init_phase", _reference_phase):
        yield
