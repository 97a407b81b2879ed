"""STT serving engine: bucketed Whisper encode + slot-batched greedy decode.

Port of ``infernos_tpu/serving/stt_engine.py`` with the same semantics:

- bucketed encode, the waveform zero-padded to the model's trained length
  (``encode_pad_s``) and the states truncated back to the bucket;
- a teacher-forced prompt prefill that also yields the no-speech
  probability at the SOT position;
- slot joins that write cross K/V (int8 when ``cross_kv_int8``) and the
  prompt's self K/V into the slot;
- ``steps_per_dispatch`` greedy steps per ``step()``, suppress ids, EOS;
- non-blocking joins: the first token stays on the device and
  ``(first_tok, ns_prob)`` are fetched once, at the slot's first harvest;
- submitters only take ``_sub_lock``; the stepping thread holds ``_lock``.

Each decode step writes its K/V row in place at the slot's position (the
reference's per-dispatch ring and merge exist only to avoid XLA scatter
copies).  The fallback ladder and beam rung are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.mel import HOP, log_mel
from ..models import layers as L
from ..models import whisper as wsp
from ..models.whisper_tokens import (BEGIN_SUPPRESS, LANG_BASE, LANGUAGES,
                                     SPECIALS_V3, SUPPRESS_V3, V2_VOCAB,
                                     decode_with_timestamps, specials_for_vocab)
from ..utils.platform import default_device

log = logging.getLogger("infernos_tpu_torch.serving.stt")

LANG_TOKENS_V3 = {code: LANG_BASE + i for i, code in enumerate(LANGUAGES)}


@dataclasses.dataclass(frozen=True)
class STTEngineConfig:
    batch_slots: int = 16
    buckets_s: Sequence[int] = (8, 16, 30)
    sample_rate: int = 16000
    max_new_tokens: int = 224
    max_prompt_tokens: int = 32
    context_tokens: int = 224  # rolling decoder context bound (sessions)
    dtype: Any = torch.float32
    lang_tokens: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(LANG_TOKENS_V3))
    task_transcribe: int = SPECIALS_V3.transcribe
    task_translate: int = SPECIALS_V3.translate
    no_timestamps: int = SPECIALS_V3.notimestamps
    no_speech: int = SPECIALS_V3.nospeech
    sot_prev: int = SPECIALS_V3.startofprev
    # None = auto: the vendored non-speech set for real whisper vocabularies
    suppress_tokens: Optional[Sequence[int]] = None
    begin_suppress_tokens: Optional[Sequence[int]] = None
    cross_kv_int8: bool = True
    # -1 = auto (the model's trained length), 0 = per-bucket encode
    encode_pad_s: int = -1
    steps_per_dispatch: int = 8
    trim_lead_silence: float = 0.0

    @property
    def max_total_tokens(self) -> int:
        return self.max_prompt_tokens + self.max_new_tokens


@dataclasses.dataclass
class STTRequest:
    audio: np.ndarray  # float32 @16 kHz
    text_cb: Callable[["STTResult"], None]
    lang: str = "en"
    mode: str = "transcribe"  # or "translate"
    timestamps: bool = False
    context: Optional[np.ndarray] = None  # previous token ids
    max_ns_prob: float = 0.5


@dataclasses.dataclass
class STTResult:
    tokens: List[int]
    no_speech_prob: float
    duration: float
    inf_time: float
    text: str = ""
    avg_logprob: float = 0.0
    compression_ratio: float = 0.0


class _Slot:
    __slots__ = ("req", "tokens", "t_start", "prompt_len", "ns_prob",
                 "sum_logprob", "pending_d")

    def __init__(self, req, prompt_len, t_start):
        self.req = req
        self.tokens: List[int] = []
        self.prompt_len = prompt_len
        self.t_start = t_start
        self.ns_prob = 0.0
        self.sum_logprob = 0.0
        self.pending_d = None  # (first_tok, ns_prob) device scalars


class STTEngine:
    def __init__(self, params: Dict[str, Any], cfg: wsp.WhisperConfig,
                 ecfg: STTEngineConfig = STTEngineConfig(),
                 detokenize: Optional[Callable[[List[int]], str]] = None,
                 device=None):
        self.device = default_device(device)
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.detokenize = detokenize or (lambda toks: " ".join(map(str, toks)))
        B = ecfg.batch_slots
        self.max_enc_len = (max(ecfg.buckets_s) * ecfg.sample_rate // HOP) // 2
        if ecfg.encode_pad_s >= 0:
            self._encode_pad_samples = ecfg.encode_pad_s * ecfg.sample_rate
        else:
            self._encode_pad_samples = max(
                cfg.max_source_positions * 2 * HOP,
                max(ecfg.buckets_s) * ecfg.sample_rate)
        self._lock = threading.RLock()
        self._sub_lock = threading.Lock()  # guards _pending only
        self._pending: deque = deque()
        self._inflight = None
        self.slots: List[Optional[_Slot]] = [None] * B
        sup = self._suppress_ids()
        self._sup = torch.tensor(sup, dtype=torch.long, device=self.device) \
            if sup else None
        first = sup + self._begin_suppress_ids()
        self._first_sup = torch.tensor(first, dtype=torch.long,
                                       device=self.device) if first else None
        self.encode_ms: List[float] = []  # host ms of each encode (synced)
        self._reset_state()

    def _reset_state(self) -> None:
        e, B, dev = self.ecfg, self.ecfg.batch_slots, self.device
        self.cache = wsp.init_cache(self.cfg, B, e.max_total_tokens,
                                    self.max_enc_len, dev, dtype=e.dtype,
                                    cross_int8=e.cross_kv_int8)
        self.enc_mask = torch.zeros((B, self.max_enc_len), dtype=torch.bool,
                                    device=dev)
        self.pos = torch.zeros(B, dtype=torch.long, device=dev)
        self.cur_tok = torch.zeros(B, dtype=torch.long, device=dev)
        self.done = torch.ones(B, dtype=torch.bool, device=dev)
        self.logp = torch.zeros(B, dtype=torch.float32, device=dev)

    # -- device programs ------------------------------------------------------

    @torch.no_grad()
    def _encode_bucket(self, audio: np.ndarray, n_samples: int):
        """``[1, n_samples]`` waveform -> encoder states ``[1, S_bucket, D]``."""
        pad = max(self._encode_pad_samples, n_samples)
        wav = np.zeros((1, pad), np.float32)
        wav[:, :n_samples] = audio
        mel = log_mel(torch.from_numpy(wav).to(self.device),
                      n_mels=self.cfg.num_mel_bins)
        enc = wsp.encode(self.params, self.cfg, mel.to(self.ecfg.dtype))
        return enc[:, : (n_samples // HOP) // 2]

    @torch.no_grad()
    def _prefill(self, tokens, enc_out, prompt_len: int, sot_pos: int):
        """Teacher-forced prompt pass -> (first_tok, ns_prob, self_k, self_v
        ``[L, 1, H, P, Dh]``); argmax and no-speech probability stay on the
        device."""
        cfg, p = self.cfg, self.params
        _, T = tokens.shape
        H = cfg.decoder_attention_heads
        x = (p["tok_embed"]["w"][tokens] + p["dec_pos"]["w"][:T]).to(self.ecfg.dtype)
        causal = L.causal_bias(T, device=self.device)
        ks, vs = [], []
        for i in range(cfg.decoder_layers):
            lp = L.layer_slice(p["dec_layers"], i)
            h_in = L.layer_norm(x, lp["ln1"])
            ks.append(L.split_heads(L.linear(h_in, lp["self_attn"]["k"]), H))
            vs.append(L.split_heads(L.linear(h_in, lp["self_attn"]["v"]), H))
            x = x + L.attention(lp["self_attn"], h_in, n_heads=H, mask=causal)
            x = x + L.attention(lp["cross_attn"], L.layer_norm(x, lp["ln2"]),
                                enc_out, n_heads=H)
            h = L.layer_norm(x, lp["ln3"])
            x = x + L.linear(L.gelu(L.linear(h, lp["fc1"])), lp["fc2"])
        x = L.layer_norm(x, p["dec_ln"])
        logits = x[0] @ p["tok_embed"]["w"].T  # [T, V]
        first_logits = logits[prompt_len - 1].clone()
        if self._first_sup is not None:
            first_logits[self._first_sup] = L.NEG_INF
        first_tok = torch.argmax(first_logits)
        probs = torch.softmax(logits[sot_pos].float(), dim=-1)
        ns = self.ecfg.no_speech
        ns_prob = probs[ns] if ns < probs.shape[0] else probs.new_zeros(())
        return first_tok, ns_prob, torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def _join(self, slot: int, enc_out, self_k, self_v, prompt_len: int,
              first_tok) -> None:
        """Write one prefilled session into ``slot`` (in place)."""
        S = enc_out.shape[1]
        ck, cv = wsp.cross_kv(self.params, self.cfg, enc_out)  # [L,1,H,S,Dh]
        pad_s = self.max_enc_len - S
        ck = F.pad(ck[:, 0], (0, 0, 0, pad_s))
        cv = F.pad(cv[:, 0], (0, 0, 0, pad_s))
        c = self.cache
        if self.ecfg.cross_kv_int8:
            for dst, src in ((c.cross_k, ck), (c.cross_v, cv)):
                qd = wsp.quantize_kv(src)
                dst["q"][:, slot] = qd["q"]
                dst["s"][:, slot] = qd["s"]
        else:
            c.cross_k[:, slot] = ck
            c.cross_v[:, slot] = cv
        P = self_k.shape[3]
        c.self_k[:, slot].zero_()
        c.self_v[:, slot].zero_()
        c.self_k[:, slot, :, :P] = self_k[:, 0]
        c.self_v[:, slot, :, :P] = self_v[:, 0]
        self.enc_mask[slot] = torch.arange(self.max_enc_len,
                                           device=self.device) < S
        self.pos[slot] = prompt_len
        self.cur_tok[slot] = first_tok
        self.done[slot] = False
        self.logp[slot] = 0.0

    @torch.no_grad()
    def _step_k(self):
        """``steps_per_dispatch`` greedy steps for all slots; returns per-step
        tokens and done flags ``[B, K]`` (device tensors)."""
        nxts, dones = [], []
        for _ in range(self.ecfg.steps_per_dispatch):
            not_done = ~self.done
            logits = wsp.decode_step(self.params, self.cfg, self.cur_tok,
                                     self.cache, self.pos,
                                     enc_mask=self.enc_mask, write=not_done)
            lf = logits.float()
            if self._sup is not None:
                lf[:, self._sup] = L.NEG_INF
            nxt = torch.argmax(lf, dim=-1)
            chosen = lf.gather(1, nxt[:, None])[:, 0] - torch.logsumexp(lf, -1)
            self.logp = torch.where(self.done, self.logp, self.logp + chosen)
            new_done = self.done | (nxt == self.cfg.eos_token_id)
            self.pos = torch.where(self.done, self.pos, self.pos + 1)
            self.cur_tok = torch.where(new_done, self.cur_tok, nxt)
            self.done = new_done
            nxts.append(nxt)
            dones.append(new_done)
        return torch.stack(nxts, 1), torch.stack(dones, 1)

    # -- public API -----------------------------------------------------------

    def warmup(self) -> None:
        """Run every bucket's encode, prefill, join and step once up front,
        so the first real utterance sees steady-state latency."""
        with self._lock:
            for b in self.ecfg.buckets_s:
                self._submit_locked(STTRequest(
                    audio=np.zeros(b * self.ecfg.sample_rate, np.float32),
                    text_cb=lambda r: None))
                while self._step_locked():
                    pass

    def abort_all(self, reason: str = "engine failure") -> None:
        """Supervision hook: complete every live and queued request with an
        empty result (ns_prob=1.0, no tokens) and reset the device state, so
        session busy/pending chains unblock and the next request starts
        clean."""
        with self._lock:
            victims = [(s.req, s.t_start) for s in self.slots if s is not None]
            with self._sub_lock:
                victims += [(r, time.monotonic()) for r in self._pending]
                self._pending.clear()
            self.slots = [None] * self.ecfg.batch_slots
            self._inflight = None
            self._reset_state()
        log.warning("stt engine abort (%s): flushing %d requests",
                    reason, len(victims))
        for req, t_start in victims:
            res = STTResult(tokens=[], no_speech_prob=1.0,
                            duration=len(req.audio) / self.ecfg.sample_rate,
                            inf_time=time.monotonic() - t_start, text="")
            try:
                req.text_cb(res)
            except Exception:
                log.exception("stt abort flush callback failed")

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _bucket_for(self, n: int) -> int:
        for s in self.ecfg.buckets_s:
            if n <= s * self.ecfg.sample_rate:
                return s
        return max(self.ecfg.buckets_s)

    def _suppress_ids(self) -> List[int]:
        sup = self.ecfg.suppress_tokens
        if sup is None:
            sup = SUPPRESS_V3 if self.cfg.vocab_size >= V2_VOCAB else ()
        return [t for t in sup if t < self.cfg.vocab_size]

    def _begin_suppress_ids(self) -> List[int]:
        sup = self.ecfg.begin_suppress_tokens
        if sup is None:
            sup = BEGIN_SUPPRESS if self.cfg.vocab_size >= V2_VOCAB else ()
        return [t for t in sup if t < self.cfg.vocab_size]

    def _build_prompt(self, req: STTRequest) -> Tuple[List[int], int]:
        """Prompt ids + index of the SOT token."""
        e = self.ecfg
        lang = e.lang_tokens.get(req.lang, next(iter(e.lang_tokens.values())))
        task = e.task_translate if req.mode == "translate" else e.task_transcribe
        tail = [self.cfg.sot_token_id, lang, task]
        if not req.timestamps:
            tail.append(e.no_timestamps)
        prompt: List[int] = []
        if req.context is not None and len(req.context):
            room = e.max_prompt_tokens - len(tail) - 1
            if room > 0:
                prompt.append(e.sot_prev)
                prompt.extend(list(req.context)[-room:])
        prompt.extend(tail)
        return prompt, len(prompt) - len(tail)

    def submit(self, req: STTRequest) -> int:
        """Queue one utterance; the stepping thread joins it at its next step.
        Never touches the engine-state lock.  Returns -1 (queued)."""
        thresh = self.ecfg.trim_lead_silence
        if thresh > 0.0 and len(req.audio):
            idx = np.flatnonzero(np.abs(req.audio) > thresh)
            if idx.size:
                req.audio = req.audio[max(0, int(idx[0]) - 160):]
        with self._sub_lock:
            self._pending.append(req)
        return -1

    def _flush_pending_locked(self, max_joins: int = 4) -> None:
        joined = 0
        while joined < max_joins and self.free_slots():
            with self._sub_lock:
                if not self._pending:
                    return
                req = self._pending.popleft()
            try:
                self._submit_locked(req)
                joined += 1
            except Exception:  # a poisoned request fails alone
                log.exception("stt: quarantining poisoned queued request")
                try:
                    req.text_cb(STTResult(tokens=[], no_speech_prob=1.0,
                                          duration=0.0, inf_time=0.0))
                except Exception:
                    log.exception("stt poison result callback failed")

    def _submit_locked(self, req: STTRequest) -> int:
        slot = self.free_slots()[0]
        e = self.ecfg
        t_start = time.monotonic()
        n = self._bucket_for(len(req.audio)) * e.sample_rate
        audio = np.zeros((1, n), np.float32)
        audio[0, : min(len(req.audio), n)] = req.audio[:n]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        enc = self._encode_bucket(audio, n)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.encode_ms.append((time.perf_counter() - t0) * 1e3)
        prompt, sot_pos = self._build_prompt(req)
        toks = torch.zeros((1, e.max_prompt_tokens), dtype=torch.long)
        toks[0, : len(prompt)] = torch.tensor(prompt)
        first_tok, ns_prob, sk, sv = self._prefill(
            toks.to(self.device), enc, len(prompt), sot_pos)
        self._join(slot, enc, sk, sv, len(prompt), first_tok)
        sess = _Slot(req, len(prompt), t_start)
        sess.pending_d = (first_tok, ns_prob)
        self.slots[slot] = sess
        return slot

    def step(self) -> bool:
        """K greedy steps across all active slots; harvest finishers."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> bool:
        self._flush_pending_locked()
        if self.n_active == 0:
            if self._inflight is not None:
                self._harvest(*self._inflight)
                self._inflight = None
                return self.n_active > 0 or bool(self._pending)
            return bool(self._pending)
        nxts, dones = self._step_k()
        # one-step pipeline: dispatch step N, harvest step N-1
        prev = self._inflight
        self._inflight = ((nxts, dones, self.logp.clone()), list(self.slots))
        if prev is not None:
            self._harvest(*prev)
        return True

    def _harvest(self, bufs, snapshot) -> None:
        nxt_np, done_np, logp_np = (b.cpu().numpy() for b in bufs)
        fresh = [s for s in snapshot if s is not None and s.pending_d is not None]
        if fresh:  # one fetch for every slot joined since the last harvest
            vals = torch.stack([torch.stack([s.pending_d[0].float(),
                                             s.pending_d[1].float()])
                                for s in fresh]).cpu().numpy()
            for s, (ft, ns) in zip(fresh, vals):
                ft = int(ft)
                if ft != self.cfg.eos_token_id:
                    s.tokens.insert(0, ft)
                s.ns_prob = float(ns)
                s.pending_d = None
        K = nxt_np.shape[1]
        for i, sess in enumerate(snapshot):
            if sess is None or self.slots[i] is not sess:
                continue
            finished = False
            for k in range(K):
                if bool(done_np[i, k]):
                    finished = True
                    break
                tok = int(nxt_np[i, k])
                if tok != self.cfg.eos_token_id:
                    sess.tokens.append(tok)
            if finished or len(sess.tokens) >= self.ecfg.max_new_tokens:
                del sess.tokens[self.ecfg.max_new_tokens:]
                sess.sum_logprob = float(logp_np[i])
                self._finish(i, sess)

    @staticmethod
    def _compression_ratio(text: str) -> float:
        b = text.encode("utf-8")
        if len(b) < 16:
            return 0.0
        return len(b) / len(zlib.compress(b))

    def _finish(self, slot: int, sess: _Slot) -> None:
        self.slots[slot] = None
        req = sess.req
        res = STTResult(tokens=sess.tokens, no_speech_prob=sess.ns_prob,
                        duration=len(req.audio) / self.ecfg.sample_rate,
                        inf_time=time.monotonic() - sess.t_start)
        res.avg_logprob = sess.sum_logprob / max(1, len(sess.tokens))
        if req.timestamps and self.cfg.vocab_size >= V2_VOCAB:
            res.text = decode_with_timestamps(
                res.tokens, self.detokenize,
                specials_for_vocab(self.cfg.vocab_size))
        else:
            res.text = self.detokenize(res.tokens)
        res.compression_ratio = self._compression_ratio(res.text)
        self._flush_pending_locked(max_joins=1)  # backfill the freed slot
        req.text_cb(res)
