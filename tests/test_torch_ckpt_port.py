"""``chip_smoke.py``'s ``ckpt_port`` phase on the CPU.

- The HF layouts the phase builds its state dicts from (``hf_*_layout``)
  give exactly the keys and shapes of HF's own ``WhisperForConditionalGeneration``,
  ``SpeechT5ForTextToSpeech`` and ``SpeechT5HifiGan`` at the presets' full
  dims, built on the meta device (no memory, no download) from HF configs
  made of the phase's stand-ins (``hf_*_config``): the card converts what a
  real checkpoint holds.
- ``port_from_hf`` of those meta models gives the presets' configs, and
  every leaf the shape the layout's row says.
- The whole phase at the tiny dims on the CPU (plain versions, no kernel):
  build, convert, check, save, reload, serve through the actors.
"""

import math

import pytest
import torch

import chip_smoke as cs
from infernos_tpu_torch.models import hifigan as hfg
from infernos_tpu_torch.models import presets
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models import whisper as wsp


def _meta_model(name):
    import transformers as tf

    if name == "whisper":
        hc, gen = cs.hf_whisper_config(presets.WHISPER_LARGE_V3)
        with torch.device("meta"):
            model = tf.WhisperForConditionalGeneration(tf.WhisperConfig(**vars(hc)))
        assert model.generation_config.decoder_start_token_id == gen.decoder_start_token_id
        return model, wsp, presets.WHISPER_LARGE_V3, cs.hf_whisper_layout
    if name == "speecht5":
        with torch.device("meta"):
            model = tf.SpeechT5ForTextToSpeech(tf.SpeechT5Config(
                **vars(cs.hf_speecht5_config(presets.SPEECHT5_FULL))))
        return model, st5, presets.SPEECHT5_FULL, cs.hf_speecht5_layout
    with torch.device("meta"):
        model = tf.SpeechT5HifiGan(tf.SpeechT5HifiGanConfig(
            **vars(cs.hf_hifigan_config(presets.HIFIGAN_FULL))))
    return model, hfg, presets.HIFIGAN_FULL, cs.hf_hifigan_layout


@pytest.mark.parametrize("name", ["whisper", "speecht5", "hifigan"])
def test_hf_layout_matches_hf_at_full_width(name):
    model, mod, cfg, layout = _meta_model(name)
    lay = layout(cfg)
    sd = model.state_dict()
    assert {r[0]: r[1] for r in lay.rows} == {k: tuple(v.shape) for k, v in sd.items()}
    assert all(sd[k].dtype == (torch.long if init == "count" else torch.float32)
               for k, _, init, _, _ in lay.rows)
    params, pcfg = mod.port_from_hf(model)
    assert pcfg == cfg
    n = 0
    for key, shape, _, path, layout_ in lay.rows:
        if path is None:
            continue
        want = shape[::-1] if layout_ in ("T", "K") else shape
        assert tuple(cs.leaf_at(params, path).shape) == want, key
        n += math.prod(shape)
    assert n == sum(t.numel() for _, t in cs.ckpt_flatten(params))


def test_phase_at_tiny_dims_on_the_cpu(capsys, monkeypatch):
    import dataclasses

    from infernos_tpu_torch.ops import attention as attn
    from infernos_tpu_torch.serving.tts_engine import TTSEngineConfig

    torch.set_num_threads(2)
    # as on the card: a draw whose greedy decode holds more than one token
    # (the tiny decoder at the card's seed emits one token throughout)
    monkeypatch.setattr(cs, "CKPT_SEED", 12)
    # fp32 on both sides here: the agreement checks hold 1e-3, and each must
    # still see the first layer's attention dropped
    for name in ("CKPT_LOGPROB_TOL", "CKPT_DEC_REL_TOL", "CKPT_ENC_REL_TOL"):
        monkeypatch.setattr(cs, name, 1e-3)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tiny = presets.WHISPER_TINY_TEST
    setup = cs.types.SimpleNamespace(
        device="cpu", tiny=True,
        # the tiny test vocabulary has no <|nospeech|>: port_from_hf takes
        # it from the vocabulary's layout, as the reference does
        whisper=dataclasses.replace(
            tiny, no_speech_token_id=wsp.specials_for_vocab(tiny.vocab_size).nospeech),
        speecht5=presets.SPEECHT5_TINY, hifigan=presets.HIFIGAN_TINY,
        stt=None,  # the tiny actor's own engine config: its vocabulary's specials
        tts=TTSEngineConfig(batch_slots=8, max_text_tokens=32, max_steps=cs.CKPT_TTS_STEPS,
                            stop_threshold=2.0, dtype=torch.float32))
    assert cs.phase_ckpt_port(torch, attn, setup) == (0, 0)
    line = [ln for ln in capsys.readouterr().out.splitlines() if '"ckpt_port"' in ln][-1]
    import json

    out = json.loads(line)
    assert out["seed"] == 12
    assert out["stt"]["encodes"] == 1 and out["stt"]["distinct"] > 1
    assert out["tts"]["finite"] and out["tts"]["samples"] == cs.CKPT_TTS_STEPS * 2 * 16
    assert out["tts"]["step_rel_err_max"] < 1e-5
    assert out["stt"]["encoder_rel_err"] < 1e-5
    assert out["stt"]["fp32_greedy_tokens"] == out["stt"]["tokens"]
    for name in ("whisper", "speecht5", "hifigan"):
        assert out[name]["bytes_on_disk"] > 2 * out[name]["elements"]
