"""Model-serving actors: TTS, STT and LLM.

Capability parity with the reference's per-model Ray actors:

- :class:`TTSActor` <-> ``Cluster/InfernTTSActor.py``: ``start(lang,
  output_sr)``, session CRUD, ``tts_session_say`` / ``stop_saying``,
  ``get_rand_voice_id`` (``:21-52``);
- :class:`STTActor` <-> ``Cluster/InfernSTTActor.py``: session CRUD +
  ``stt_session_soundin`` (``:38-53``);
- :class:`LLMActor` <-> ``Cluster/InfernLLMActor.py``: chat sessions,
  ``llm_session_textin`` / ``context_add`` (``:42-70``).

Each actor owns one slot-batched engine plus its driver thread; the actor
mailbox serializes session bookkeeping while the engine free-runs.

Port of ``infernos_tpu/cluster/model_actors.py``.  What differs, and why:

- ``device`` places the engine: the card unless the caller asks for the
  CPU (``utils.platform.default_device`` raises without one).
- The serving dtype is :func:`~..models.tiny_real.serving_dtype`, the
  reference's rule: tiny random and tiny-real starts are fp32 on every
  device, full-dims starts bf16 on the card (the reference's bf16 on a
  TPU) and fp32 on the CPU.
- Full-dims starts without weights zero-initialise, as the reference
  does, but allocate the zeros directly on the device in the serving
  dtype: the parameter shapes are traced with fake tensors first (no
  memory, no random draw), never materialised as an fp32 copy.
- Tiny random starts draw from a seeded ``torch.Generator``; they cannot
  equal the reference's draw, so parity tests pass the reference's weights
  in through ``params=`` (``models/convert.py`` ``from_jax_params``).  The
  tiny dims have head dim 12, which the encoder attention kernel does not
  take: on the card a tiny random start fails with the kernel's error.
- ``INFERNOS_MODEL_MODE=tiny-real`` without the trained checkpoint raises
  in every actor; the reference warns and serves random weights, which
  would let a tiny-real run quietly measure other models.
- The full LLM start (Qwen2.5-7B) allocates its zeros directly in the
  int8 layout (``models/quant.py``; shapes from fake tensors, scales fp32
  as the port keeps them), never as a dense copy; its embedding and
  readout are drawn from a seeded generator on the device and its final
  norm is ones, as the reference starts it.
"""

from __future__ import annotations

import dataclasses
import os
import uuid as uuid_mod
from typing import Callable, Dict, Optional

import torch

from ..models import hifigan as hfg
from ..models import presets
from ..models import qwen
from ..models import speecht5 as st5
from ..models import whisper as wsp
from ..models.convert import cast_floating
from ..models.tiny_real import serving_dtype
from ..models.tokenizers import ByteTokenizer, CharTokenizer
from ..serving.driver import EngineDriver
from ..serving.llm_engine import LLMEngine, LLMEngineConfig
from ..serving.sessions import LLMSession, STTSession, TTSRequest, TTSSession
from ..serving.speakers import SpeakerBank
from ..serving.stt_engine import STTEngine, STTEngineConfig
from ..serving.tts_engine import TTSEngine, TTSEngineConfig
from ..utils.logging import get_logger
from ..utils.platform import default_device
from .actors import Actor

log = get_logger("cluster.models")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def zeros_init(init_fn, device: torch.device, dtype: torch.dtype):
    """Full-dims engines without a checkpoint initialize to zeros: weight
    VALUES are irrelevant until real checkpoints are ported (PERF.md).
    ``init_fn(generator, device, dtype)`` runs under fake tensors, which
    give the tree's shapes without memory or a random draw (the role of
    the reference's ``jax.eval_shape``); the zeros are then allocated on
    ``device`` in ``dtype`` (non-floating leaves keep their type)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        shapes = init_fn(torch.Generator(), "cpu", torch.float32)
    return _tree_map(lambda t: torch.zeros(
        t.shape, dtype=dtype if t.is_floating_point() else t.dtype,
        device=device), shapes)


def qwen_int8_init(cfg: qwen.QwenConfig, device: torch.device,
                   dtype: torch.dtype, seed: int = 0):
    """The full LLM start's weights: zeros in the int8 layout of
    ``quant.quantize_params(qwen.init_params(...))`` (codes int8, scales
    fp32, the rest ``dtype``), an ``N(0, 0.02)`` embedding and readout from
    a generator seeded with ``seed`` on ``device``, and a final norm of
    ones.  All-zero weights collapse generation to token 0, which
    detokenizes to an empty reply; the random embedding and readout give a
    varied token stream through the residual path."""
    from ..models import quant

    params = zeros_init(lambda g, d, t: quant.quantize_params(
        qwen.init_params(cfg, g, d, t)), device, dtype)
    for node in params["layers"].values():
        if "w_q" in node:
            node["scale"] = node["scale"].float()
    g = torch.Generator(device=device).manual_seed(seed)
    for key in ("embed", "lm_head"):
        if key in params:
            params[key]["w"].normal_(0.0, 0.02, generator=g)
    params["ln_f"]["g"].fill_(1.0)
    return params


class TTSActor(Actor):
    def __init__(self, tiny: bool = True, seed: int = 0,
                 ecfg: Optional[TTSEngineConfig] = None,
                 params=None, voc_params=None, device=None):
        self.tiny = tiny
        self.seed = seed
        self.ecfg = ecfg
        self._params = params
        self._voc_params = voc_params
        self.device = device
        self.sessions: Dict[uuid_mod.UUID, TTSSession] = {}
        self.engine: Optional[TTSEngine] = None
        self.driver: Optional[EngineDriver] = None

    def start(self, lang: str = "en", output_sr: int = 16000) -> None:
        dev = default_device(self.device)
        if os.environ.get("INFERNOS_MODEL_MODE") == "tiny-real":
            from ..models import tiny_real

            if tiny_real.have_tiny_tts():
                return self._start_tiny_real(lang, dev)
            raise RuntimeError(
                "INFERNOS_MODEL_MODE=tiny-real but no trained tiny TTS "
                f"checkpoint in {tiny_real.data_path('tiny_tts')}")
        cfg = presets.SPEECHT5_TINY if self.tiny else presets.SPEECHT5_FULL
        voc = presets.HIFIGAN_TINY if self.tiny else presets.HIFIGAN_FULL
        dtype = serving_dtype(dev, tiny=self.tiny)
        if self._params is not None:
            params = cast_floating(self._params, dtype)
        elif self.tiny:
            params = st5.init_params(
                cfg, torch.Generator().manual_seed(self.seed), dev, dtype)
        else:
            params = zeros_init(
                lambda g, d, t: st5.init_params(cfg, g, d, t), dev, dtype)
        if self._voc_params is not None:
            voc_params = cast_floating(self._voc_params, dtype)
        elif self.tiny:
            voc_params = hfg.init_params(
                voc, torch.Generator().manual_seed(self.seed + 1), dev, dtype)
        else:
            voc_params = zeros_init(
                lambda g, d, t: hfg.init_params(voc, g, d, t), dev, dtype)
        ecfg = self.ecfg or TTSEngineConfig(
            # INFERNOS_TTS_SLOTS: call-ramp benches widen slots; 8 is the
            # reference's worker batch (Cluster/InfernTTSWorker.py:57).  The
            # card's step kernel takes at most 32 (TTSEngine refuses more).
            batch_slots=4 if self.tiny else int(
                os.environ.get("INFERNOS_TTS_SLOTS", "8")),
            max_text_tokens=32 if self.tiny else 96,
            max_steps=64 if self.tiny else 512,
            stop_threshold=2.0,  # random weights never emit a stop token
            dtype=dtype,
            # random/zeros weights synthesize ~3e-5 peak -- below the G.711
            # mu-law floor, i.e. digital silence on a PCMU leg.  Normalize
            # the plumbing stand-in to real speech loudness (only when no
            # externally trained params were provided).
            output_norm_rms=0.05 if self._params is None else 0.0,
        )
        self.lang = lang
        self.tokenizer = CharTokenizer()
        self.bank = SpeakerBank.synthetic(dim=cfg.speaker_embedding_dim)
        # chunk-boundary smoother: in-repo trained declicker when available
        # (full-dims engines only; its conditioning is 80-mel x 256-sample
        # frames, the reference post-vocoder geometry)
        amd_params = None
        if not self.tiny:
            from ..models import amendnet as amd

            amd_params = amd.load_pretrained(dev)
        self.engine = TTSEngine(params, cfg, voc_params, voc, ecfg,
                                amd_params=amd_params, device=dev)
        self._run_engine()
        log.info("TTSActor started (lang=%s tiny=%s device=%s)", lang,
                 self.tiny, dev)

    def _start_tiny_real(self, lang: str, dev: torch.device) -> None:
        """Serve the in-repo-trained tiny SpeechT5 with its vocoder
        (``INFERNOS_TTS_VOCODER``): real stop tokens, real speech."""
        from ..models import tiny_real

        params, cfg, voc_params, vcfg, tok, table = \
            tiny_real.load_tiny_tts(device=dev)
        ecfg = self.ecfg or TTSEngineConfig(
            batch_slots=8, max_text_tokens=48, max_steps=170,
            stop_threshold=0.5,  # trained stop tokens actually fire
            dtype=serving_dtype(dev, tiny=True),
        )
        self.lang = lang
        self.tokenizer = tok
        self.bank = SpeakerBank(table)
        self.engine = TTSEngine(params, cfg, voc_params, vcfg, ecfg, device=dev)
        self._run_engine()
        log.info("TTSActor started (lang=%s tiny-real trained pair, "
                 "device=%s)", lang, dev)

    def _run_engine(self) -> None:
        self.engine.warmup()
        self.driver = EngineDriver(self.engine, name="tts")
        self.driver.start()

    def on_stop(self) -> None:
        if self.driver:
            self.driver.stop(join=False)

    # -- session API ----------------------------------------------------------
    def new_tts_session(self) -> uuid_mod.UUID:
        sess = TTSSession(self.engine, tokenize=self.tokenizer,
                          speaker_bank=self.bank)
        self.sessions[sess.id] = sess
        return sess.id

    def tts_session_start(self, sess_id: uuid_mod.UUID, soundout: Callable) -> None:
        self.sessions[sess_id].start(soundout)

    def tts_session_say(self, sess_id: uuid_mod.UUID, req: TTSRequest):
        say_id = self.sessions[sess_id].say(req)
        self.driver.kick()
        return say_id

    def tts_session_stop_saying(self, sess_id: uuid_mod.UUID, say_id) -> bool:
        return self.sessions[sess_id].stop_saying(say_id)

    def tts_session_end(self, sess_id: uuid_mod.UUID) -> None:
        sess = self.sessions.pop(sess_id, None)
        if sess is not None:
            sess.end()

    def get_rand_voice_id(self) -> int:
        return self.bank.rand_id()


class STTActor(Actor):
    def __init__(self, tiny: bool = True, seed: int = 0,
                 ecfg: Optional[STTEngineConfig] = None, params=None,
                 device=None):
        self.tiny = tiny
        self.seed = seed
        self.ecfg = ecfg
        self._params = params
        self.device = device
        self.sessions: Dict[uuid_mod.UUID, STTSession] = {}
        self.engine = None
        self.driver: Optional[EngineDriver] = None

    def start(self) -> None:
        dev = default_device(self.device)
        if os.environ.get("INFERNOS_MODEL_MODE") == "tiny-real":
            from ..models import tiny_real

            if tiny_real.have_tiny_stt():
                return self._start_tiny_real(dev)
            raise RuntimeError(
                "INFERNOS_MODEL_MODE=tiny-real but no trained tiny STT "
                f"checkpoint in {tiny_real.data_path('tiny_stt')}")
        cfg = presets.WHISPER_TINY_TEST if self.tiny else presets.WHISPER_LARGE_V3
        dtype = serving_dtype(dev, tiny=self.tiny)
        # sot_prev: the reference leaves large-v3's 50362 in the tiny config,
        # outside its 128-token vocabulary (JAX clamps the read; torch
        # raises, which quarantined every request with context)
        ecfg = self.ecfg or (
            STTEngineConfig(batch_slots=4, buckets_s=(2, 8),
                            max_new_tokens=8, max_prompt_tokens=8,
                            lang_tokens={"en": 10, "pt": 11}, task_transcribe=12,
                            task_translate=13, no_timestamps=14, no_speech=4,
                            sot_prev=15, dtype=dtype)
            if self.tiny else STTEngineConfig(dtype=dtype))
        # INFERNOS_STT_MAX_NEW: decode-length cap.  Benches with random
        # weights set a representative cap (real transcripts of telephony
        # utterances are 10-30 tokens) because zero-logit argmax never emits
        # EOS and would burn the full 224-token budget per utterance.
        cap = os.environ.get("INFERNOS_STT_MAX_NEW")
        if cap and self.ecfg is None:
            ecfg = dataclasses.replace(ecfg, max_new_tokens=int(cap))
        if self._params is not None:
            params = cast_floating(self._params, ecfg.dtype)
        elif self.tiny:
            params = wsp.init_params(
                cfg, torch.Generator().manual_seed(self.seed), dev, ecfg.dtype)
        else:
            params = zeros_init(
                lambda g, d, t: wsp.init_params(cfg, g, d, t), dev, ecfg.dtype)
        if self.tiny or self.ecfg is not None:
            self.engine = STTEngine(params, cfg, ecfg, device=dev)
        else:
            # tiered serving: short utterances (the telephony common case)
            # decode against short cross-caches
            from ..serving.stt_tiered import TieredSTTConfig, TieredSTTEngine

            # INFERNOS_STT_SLOTS: short-tier width.  int8 cross-KV keeps
            # 32 8-s slots ~1 GB.
            self.engine = TieredSTTEngine(
                params, cfg,
                TieredSTTConfig(
                    short_max_s=8,
                    short_slots=int(os.environ.get("INFERNOS_STT_SLOTS", "24")),
                    long_slots=8, dtype=ecfg.dtype,
                    base=dataclasses.replace(ecfg)),
                device=dev)
        self._run_engine()
        log.info("STTActor started (tiny=%s device=%s)", self.tiny, dev)

    def _start_tiny_real(self, dev: torch.device) -> None:
        """Serve the in-repo-trained tiny Whisper: real transcripts, real
        EOS -- turn latency without the garbage-decode artifact."""
        from ..models import tiny_real

        params, cfg, tok, ecfg = tiny_real.load_tiny_stt(dev)
        if self.ecfg is not None:
            ecfg = self.ecfg
        self.engine = STTEngine(params, cfg, ecfg, detokenize=tok.detokenize,
                                device=dev)
        self._run_engine()
        log.info("STTActor started (tiny-real trained whisper, device=%s)", dev)

    def _run_engine(self) -> None:
        self.engine.warmup()
        self.driver = EngineDriver(self.engine, name="stt")
        self.driver.start()

    def on_stop(self) -> None:
        if self.driver:
            self.driver.stop(join=False)

    def new_stt_session(self, keep_context: bool = False) -> uuid_mod.UUID:
        eng = self.engine

        class _KickingEngine:
            """Submit then kick the driver (engine free-runs)."""

            ecfg = eng.ecfg

            def submit(inner_self, req):
                slot = eng.submit(req)
                self.driver.kick()
                return slot

        sess = STTSession(_KickingEngine(), keep_context=keep_context)
        self.sessions[sess.id] = sess
        return sess.id

    def stt_session_soundin(self, sess_id: uuid_mod.UUID, req) -> None:
        self.sessions[sess_id].soundin(req)

    def stt_session_end(self, sess_id: uuid_mod.UUID) -> None:
        sess = self.sessions.pop(sess_id, None)
        if sess is not None:
            sess.stop()


# the LLM actor's engines, each served in the start's dtype
LLM_TINY_ENGINE = LLMEngineConfig(batch_slots=2, prompt_buckets=(64, 128),
                                  max_total_tokens=192, max_new_tokens=24)
# colocated serving (the attendant shares the card with STT and TTS): 4
# slots x 1k context keep the KV cache near 0.1 GB
LLM_FULL_ENGINE = LLMEngineConfig(batch_slots=4, prompt_buckets=(128, 256, 512),
                                  max_total_tokens=1024, max_new_tokens=256)
# the trained tiny LLM's examples are <= 384 tokens; leave generation headroom
LLM_TINY_REAL_ENGINE = LLMEngineConfig(batch_slots=4, prompt_buckets=(128, 256, 384),
                                       max_total_tokens=448, max_new_tokens=64)


class LLMActor(Actor):
    def __init__(self, tiny: bool = True, seed: int = 0,
                 ecfg: Optional[LLMEngineConfig] = None, params=None,
                 device=None):
        self.tiny = tiny
        self.seed = seed
        self.ecfg = ecfg
        self._params = params
        self.device = device
        self.sessions: Dict[uuid_mod.UUID, LLMSession] = {}
        self.engine: Optional[LLMEngine] = None
        self.driver: Optional[EngineDriver] = None
        self.tokenizer = ByteTokenizer()

    def start(self) -> None:
        dev = default_device(self.device)
        if os.environ.get("INFERNOS_MODEL_MODE") == "tiny-real":
            from ..models import tiny_real

            if tiny_real.have_tiny_llm():
                return self._start_tiny_real(dev)
            raise RuntimeError(
                "INFERNOS_MODEL_MODE=tiny-real but no trained tiny LLM "
                f"checkpoint in {tiny_real.data_path('tiny_llm')}")
        # one card serves the 7B at int8 (about 8.7 GB of weights); the
        # reference's 14B target (Cluster/InfernLLMWorker.py:64) fits one
        # 80 GB card too (15.2 GiB in int8, parallel/budget.py)
        cfg = presets.QWEN_TINY if self.tiny else presets.QWEN25_7B
        dtype = serving_dtype(dev, tiny=self.tiny)
        ecfg = self.ecfg or dataclasses.replace(
            LLM_TINY_ENGINE if self.tiny else LLM_FULL_ENGINE, dtype=dtype)
        if self._params is not None:
            params = cast_floating(self._params, dtype)
        elif self.tiny:
            params = qwen.init_params(
                cfg, torch.Generator().manual_seed(self.seed), dev, dtype)
        else:
            params = qwen_int8_init(cfg, dev, dtype, self.seed)
        self._run_engine(params, cfg, ecfg, dev)
        log.info("LLMActor started (tiny=%s device=%s)", self.tiny, dev)

    def _start_tiny_real(self, dev: torch.device) -> None:
        """Serve the in-repo-trained attendant LLM (tools/train_tiny_llm.py):
        real replies within the speechlang vocabulary, EOS from data."""
        from ..models import tiny_real

        params, cfg = tiny_real.load_tiny_llm(dev)
        ecfg = self.ecfg or dataclasses.replace(LLM_TINY_REAL_ENGINE,
                                                dtype=serving_dtype(dev, tiny=True))
        self._run_engine(params, cfg, ecfg, dev)
        log.info("LLMActor started (tiny-real trained attendant, device=%s)", dev)

    def _run_engine(self, params, cfg, ecfg, dev) -> None:
        self.engine = LLMEngine(params, cfg, ecfg,
                                detokenize=self.tokenizer.detokenize, device=dev)
        self.engine.warmup()
        self.driver = EngineDriver(self.engine, name="llm")
        self.driver.start()

    def on_stop(self) -> None:
        if self.driver:
            self.driver.stop(join=False)

    def new_llm_session(self, system_prompt: str = "") -> uuid_mod.UUID:
        sess = LLMSession(self.engine, tokenize=self.tokenizer,
                          system_prompt=system_prompt)
        self.sessions[sess.id] = sess
        return sess.id

    def llm_session_textin(self, sess_id: uuid_mod.UUID, text: str,
                           result_cb, auto_ctx_add: bool = True,
                           req_id=None) -> int:
        req_id = self.sessions[sess_id].textin(text, result_cb,
                                               auto_ctx_add=auto_ctx_add,
                                               req_id=req_id)
        self.driver.kick()
        return req_id

    def llm_session_context_add(self, sess_id: uuid_mod.UUID, content: str,
                                role: str = "user") -> None:
        self.sessions[sess_id].context_add(content, role=role)

    def llm_session_end(self, sess_id: uuid_mod.UUID) -> None:
        self.sessions.pop(sess_id, None)
