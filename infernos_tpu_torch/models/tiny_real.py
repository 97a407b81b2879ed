"""Loaders for the in-repo-trained tiny-but-real STT/TTS/LLM trio.

Port of ``infernos_tpu/models/tiny_real.py``.  ``tools/train_tiny_stt.py``
and ``tools/train_tiny_tts.py`` train small Whisper and SpeechT5 configs on
the synthetic spoken language (``tools/speechlang.py``) until transcripts
round-trip; ``tools/train_tiny_llm.py`` trains a small Qwen config on the
attendant policy, whose replies use that language's words.  Serving them makes every end-to-end number meaningful: EOS
fires from data and a transcript can be checked word for word.

The checkpoints are read by path from ``infernos_tpu/models/data/tiny_*``
(``npz_io.data_path``; a file read, not an import).  The loaders return the
port's configs, tensors on ``default_device(device)`` and the port's
tokenizers (``models/bpe.py``, ``models/spm.py``).

Dtype: the reference's rule (:func:`serving_dtype`).  The tiny-real trio
is served in fp32 on every device, as the reference serves it on a TPU:
on the card its encoder runs the attention kernel's fp32 mode and its TTS
the decoder-step kernel over fp32 caches.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..utils.platform import default_device
from .npz_io import data_path, load_params

# Contract with tools/train_tiny_stt.py: byte alphabet 0..255, then these
# specials in order (a fresh save also writes special_tokens.json).
STT_SPECIALS = ["<|sot|>", "<|eos|>", "<|nospeech|>", "<|pad|>",
                "<|lang_en|>", "<|transcribe|>", "<|notimestamps|>",
                "<|startofprev|>"]


def have_tiny_stt() -> bool:
    return os.path.exists(os.path.join(data_path("tiny_stt"), "params.npz"))


def have_tiny_tts() -> bool:
    return os.path.exists(os.path.join(data_path("tiny_tts"),
                                       "t5_params.npz"))


def have_tiny_llm() -> bool:
    return os.path.exists(os.path.join(data_path("tiny_llm"), "params.npz"))


def serving_dtype(device, *, tiny: bool) -> torch.dtype:
    """The reference's serving dtype (``infernos_tpu/cluster/model_actors.py``
    ``_serving_dtype`` and its tiny starts): a tiny or tiny-real engine is
    fp32 on every device; a full-width engine is bf16 on the card (the
    reference's bf16 on a TPU) and fp32 elsewhere."""
    if tiny:
        return torch.float32
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def _load_cfg(directory: str, cls, name: str = "config.json"):
    with open(os.path.join(directory, name)) as f:
        d = json.load(f)
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k in fields:
            kw[k] = tuple(v) if isinstance(v, list) else v
    # nested tuples (hifigan resblock_dilation_sizes)
    for k, v in kw.items():
        if isinstance(v, tuple) and v and isinstance(v[0], list):
            kw[k] = tuple(tuple(x) for x in v)
    return cls(**kw)


def load_tiny_stt(device=None):
    """-> (params, WhisperConfig, tokenizer, STTEngineConfig) on
    ``default_device(device)``."""
    from ..serving.stt_engine import STTEngineConfig
    from .bpe import ByteLevelBPE
    from .whisper import WhisperConfig

    dev = default_device(device)
    dtype = serving_dtype(dev, tiny=True)
    d = data_path("tiny_stt")
    cfg = _load_cfg(d, WhisperConfig)
    params = load_params(os.path.join(d, "params.npz"), dev, dtype)
    sp_path = os.path.join(d, "special_tokens.json")
    if os.path.exists(sp_path):
        with open(sp_path) as f:
            specials = json.load(f)
    else:
        specials = {t: 256 + i for i, t in enumerate(STT_SPECIALS)}
    tok = ByteLevelBPE.from_files(
        os.path.join(d, "tokenizer", "vocab.json"),
        os.path.join(d, "tokenizer", "merges.txt"),
        special_tokens=specials)
    ecfg = STTEngineConfig(
        batch_slots=8,
        buckets_s=(2, 5),  # model trained on <=5 s utterances
        max_new_tokens=40,
        max_prompt_tokens=16,
        context_tokens=10,
        dtype=dtype,
        lang_tokens={"en": specials["<|lang_en|>"],
                     # language-conditioned checkpoints carry a true pt
                     # token; older en-only ones route pt -> en
                     "pt": specials.get("<|lang_pt|>",
                                        specials["<|lang_en|>"])},
        task_transcribe=specials["<|transcribe|>"],
        task_translate=specials["<|transcribe|>"],  # translate untrained
        no_timestamps=specials["<|notimestamps|>"],
        no_speech=specials["<|nospeech|>"],
        sot_prev=specials["<|startofprev|>"],
        suppress_tokens=(), begin_suppress_tokens=(),
        cross_kv_int8=False,
        # the tiny model trains on renders starting at t=0; VAD pre-roll
        # silence garbles it
        trim_lead_silence=3e-3,
    )
    return params, cfg, tok, ecfg


def load_tiny_tts(vocoder: str = None, device=None):
    """-> (t5_params, SpeechT5Config, voc_params, voc_cfg, tokenizer,
    speaker_table [N, spk_dim] numpy) on ``default_device(device)``.

    ``vocoder`` (or ``INFERNOS_TTS_VOCODER``): ``"gl"`` (default) serves
    the deterministic Griffin-Lim mel inverter -- the in-repo GAN-less
    HiFi-GAN destroys formant content; ``"hifigan"`` serves the trained
    checkpoint (the path real ported weights use).  Griffin-Lim's
    parameters stay fp32 (it computes in fp32)."""
    from ..audio import griffinlim as gl
    from .hifigan import HifiGanConfig
    from .speecht5 import SpeechT5Config
    from .spm import load_spm_model

    dev = default_device(device)
    dtype = serving_dtype(dev, tiny=True)
    d = data_path("tiny_tts")
    cfg = _load_cfg(d, SpeechT5Config)
    params = load_params(os.path.join(d, "t5_params.npz"), dev, dtype)
    tok = load_spm_model(os.path.join(d, "tokenizer", "spiece.model"))
    table = np.load(os.path.join(d, "speakers.npz"))["table"]
    if vocoder is None:
        vocoder = os.environ.get("INFERNOS_TTS_VOCODER", "gl")
    if vocoder == "gl":
        vcfg = gl.GriffinLimConfig(n_mels=cfg.num_mel_bins)
        voc_params = gl.init_params(vcfg, dev)
    else:
        vcfg = _load_cfg(d, HifiGanConfig, "voc_config.json")
        voc_params = load_params(os.path.join(d, "voc_params.npz"), dev, dtype)
    return params, cfg, voc_params, vcfg, tok, table


def load_tiny_llm(device=None):
    """-> (params, QwenConfig) on ``default_device(device)``, in
    :func:`serving_dtype`.

    Trained by ``tools/train_tiny_llm.py`` on the attendant-policy dialogue
    task; its tokenizer is the plain ``ByteTokenizer`` (the trainer encodes
    ChatML with it, so no tokenizer files are needed).
    """
    from .qwen import QwenConfig

    dev = default_device(device)
    d = data_path("tiny_llm")
    cfg = _load_cfg(d, QwenConfig)
    params = load_params(os.path.join(d, "params.npz"), dev, serving_dtype(dev, tiny=True))
    return params, cfg
