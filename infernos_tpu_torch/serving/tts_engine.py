"""Streaming TTS engine: slot-batched continuous AR decode.

Port of ``infernos_tpu/serving/tts_engine.py`` with the same semantics:
fixed ``[B]`` slots that sessions join (batched text encodes, cross K/V
written into the slot) and leave by flag; emissions of ``chunk_schedule``
mel frames picked by the youngest running session; paused slots keep their
AR state frozen (their cache write at the unadvanced ``pos`` is overwritten
on resume); stop threshold with ``min_steps``; vocode of each chunk with
``pre_frames`` of left context through postnet, HiFi-GAN and AmendNet; and
a one-tick harvest pipeline, or, with ``async_harvest``, a harvest thread
behind a bounded dispatch pipeline.  Every decoder step goes through
:func:`infernos_tpu_torch.ops.tts_step.fused_decode_step` (the CUDA kernel
chain on the card) with weights packed once at init; a parameter tree
quantized by ``models/quant.py`` packs to int8 codes and runs the chain's
int8 mode, its encoder, prenet and cross K/V go through ``layers.linear``.

A tick's results travel to the host in one copy each.  On the card the copy
goes into pinned memory and is followed by a CUDA event; a harvest waits on
that event only, never on the whole stream, so the stepping thread can
queue the next tick while an earlier one is delivered.

``output_norm_rms`` is carried as a config field; the gain is applied by
``serving.sessions.TTSSoundDispatch``.  The vocoder is chosen by its
config's type, as in the reference: a ``GriffinLimConfig`` vocodes with
``audio/griffinlim.py`` (the tiny-real default), a ``HifiGanConfig`` with
``models/hifigan.py``.

An engine takes any number of slots, as the reference does.  On the card,
over bf16 caches one step kernel launch takes at most
``ops.tts_step.MAX_B`` slots, so a step of more slots is one launch per
group of at most ``MAX_B`` (``ops.tts_step.run_groups``); over fp32
caches (the tiny and tiny-real engines) every step is one launch of the
cluster kernel; a CUDA engine of no slots is refused at construction
(:func:`check_slots`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..audio import griffinlim as gl
from ..models import amendnet as amd
from ..models import hifigan as hfg
from ..models import speecht5 as st5
from ..ops.tts_step import fused_decode_step, pack_fused_weights
from ..utils.logging import get_logger
from ..utils.metrics import metrics
from ..utils.platform import default_device
from .fetch import HostFetch

log = get_logger("serving.tts")


@dataclasses.dataclass(frozen=True)
class TTSEngineConfig:
    batch_slots: int = 8
    max_text_tokens: int = 96
    max_steps: int = 512  # decoder steps (x reduction_factor mel frames)
    pre_frames: int = 4  # vocoder left-context carry-over
    chunk_schedule: Sequence[int] = (8, 8, 16, 32)  # mel frames per emission
    min_steps: int = 4  # no stop before this many decoder steps
    stop_threshold: float = 0.5
    sample_rate: int = 16000
    dtype: Any = torch.float32
    # async harvest: a dedicated thread fetches and delivers each tick's
    # audio the moment the device finishes it, instead of at the NEXT
    # step's dispatch (the sync one-tick pipeline), keeping up to
    # ``max_inflight_ticks`` dispatches queued on the device
    async_harvest: bool = False
    max_inflight_ticks: int = 2
    # per-utterance output loudness target (0 = off); applied by sessions
    output_norm_rms: float = 0.0


@dataclasses.dataclass
class TTSState:
    """Device-resident slot-batched decode state (updated in place)."""

    cache: st5.DecoderCache
    enc_mask: torch.Tensor  # [B, S] bool
    spk: torch.Tensor  # [B, spk_dim]
    prev_mel: torch.Tensor  # [B, 1, M] last emitted mel frame (AR input)
    pos: torch.Tensor  # [B] int64 decoder step per slot
    stopped: torch.Tensor  # [B] bool stop-token fired
    active: torch.Tensor  # [B] bool slot occupied
    mel_ctx: torch.Tensor  # [B, pre_frames, M] raw-mel vocoder context


class _Session:
    __slots__ = ("sid", "slot", "callback", "frames_sent", "chunks_recv",
                 "max_frames", "t_start", "t_first", "cancelled", "paused")

    def __init__(self, sid, slot, callback, max_frames):
        self.sid = sid
        self.slot = slot
        self.callback = callback
        self.frames_sent = 0
        self.chunks_recv = 0
        self.max_frames = max_frames
        self.t_start = time.monotonic()
        self.t_first: Optional[float] = None
        self.cancelled = False
        self.paused = False


def check_slots(batch_slots: int, device: torch.device) -> None:
    """Refuse a slot count the step kernel cannot take on ``device``: on
    a CUDA device it takes 1 slot or more (more than ``MAX_B`` in groups);
    the plain CPU path takes any."""
    if torch.device(device).type == "cuda" and batch_slots < 1:
        raise ValueError(
            f"TTSEngine: batch_slots {batch_slots}: the decoder-step kernel "
            f"takes 1 slot or more on the card")


class TTSEngine:
    """Host-side scheduler around the decode and vocode passes; drive it
    from one thread (``step()``), submit from any (``start_session``)."""

    def __init__(self, params: Dict[str, Any], cfg: st5.SpeechT5Config,
                 voc_params: Dict[str, Any],
                 voc_cfg: "hfg.HifiGanConfig | gl.GriffinLimConfig",
                 ecfg: TTSEngineConfig = TTSEngineConfig(),
                 amd_params: Optional[Dict[str, Any]] = None,
                 rng_seed: int = 0, device=None):
        self.device = default_device(device)
        check_slots(ecfg.batch_slots, self.device)
        self.cfg, self.ecfg, self.voc_cfg = cfg, ecfg, voc_cfg
        self.params, self.voc_params = params, voc_params
        self.amd_cfg = amd.AmendNetConfig(
            num_mels=cfg.num_mel_bins, frame_size=voc_cfg.total_upsample,
            pre_frames=ecfg.pre_frames, post_frames=0)
        if amd_params is not None:  # match the engine's activation dtype
            from ..models.convert import cast_floating

            amd_params = cast_floating(amd_params, ecfg.dtype)
        self.amd_params = amd_params
        self._lock = threading.RLock()  # the stepping thread: whole ticks
        self._sub_lock = threading.Lock()  # guards _pending + _next_sid only
        self._pending: deque = deque()
        self._next_sid = 0
        self._inflight = None
        self._async = ecfg.async_harvest
        if self._async:
            self._hq: "queue.Queue" = queue.Queue()
            self._sem = threading.Semaphore(ecfg.max_inflight_ticks)
            self._inflight_n = 0
            self._idle_cv = threading.Condition()
            self._hthread = threading.Thread(
                target=self._harvest_loop, daemon=True, name="tts-harvest")
            self._hthread.start()
        self.sessions: List[Optional[_Session]] = [None] * ecfg.batch_slots
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        # weights packed ONCE: packing per step would re-copy every weight;
        # bf16 on the card whatever ecfg.dtype (the reference's wdt), the
        # engine's dtype on the CPU
        self.packed = pack_fused_weights(params, cfg, ecfg.dtype)
        self.tick_ms: List[float] = []  # host ms between dispatches
        self.tick_frames: List[int] = []  # mel frames of each dispatched tick
        self._last_dispatch_t: Optional[float] = None
        self.state = self._init_state()

    # -- state management -----------------------------------------------------

    def _init_state(self) -> TTSState:
        cfg, e, dev = self.cfg, self.ecfg, self.device
        B, M = e.batch_slots, cfg.num_mel_bins

        def z(*shape, dtype=e.dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return TTSState(
            cache=st5.init_cache(cfg, B, e.max_steps, e.max_text_tokens, dev,
                                 dtype=e.dtype),
            enc_mask=z(B, e.max_text_tokens, dtype=torch.bool),
            spk=z(B, cfg.speaker_embedding_dim),
            prev_mel=z(B, 1, M),
            pos=z(B, dtype=torch.long),
            stopped=z(B, dtype=torch.bool),
            active=z(B, dtype=torch.bool),
            mel_ctx=z(B, e.pre_frames, M))

    @torch.no_grad()
    def _join_many(self, slots: List[int], input_ids, attn_mask, spk) -> None:
        """Encode the sessions' texts in ONE batch and write their slots."""
        cfg, st = self.cfg, self.state
        enc = st5.encode_text(self.params, cfg, input_ids, attn_mask)
        ck, cv = st5.cross_kv(self.params, cfg, enc.to(self.ecfg.dtype))
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        c = st.cache
        c.cross_k[:, idx] = ck.to(c.cross_k.dtype)
        c.cross_v[:, idx] = cv.to(c.cross_v.dtype)
        c.self_k[:, idx] = 0
        c.self_v[:, idx] = 0
        st.enc_mask[idx] = attn_mask.bool()
        st.spk[idx] = spk.to(st.spk.dtype)
        st.prev_mel[idx] = 0
        st.pos[idx] = 0
        st.stopped[idx] = False
        st.active[idx] = True
        st.mel_ctx[idx] = 0

    def _leave(self, slot: int) -> None:
        self.state.active[slot] = False
        self.state.stopped[slot] = False

    # -- decode ---------------------------------------------------------------

    @torch.no_grad()
    def _decode_chunk(self, paused, n_frames: int):
        """``n_frames // r`` AR steps for all slots -> (mels ``[B, n_frames,
        M]``, frame_valid ``[B, n_frames]``)."""
        cfg, e, st = self.cfg, self.ecfg, self.state
        r = cfg.reduction_factor
        mels, runs = [], []
        for _ in range(n_frames // r):
            x = st5.decoder_prenet(self.params, cfg, st.prev_mel, st.spk,
                                   step_offset=st.pos, generator=self._gen)
            h = fused_decode_step(self.params, cfg, x, st.cache, st.pos,
                                  enc_mask=st.enc_mask, packed=self.packed)
            mel, logits = st5.feat_and_prob(self.params, cfg, h)
            run = st.active & ~st.stopped & ~paused
            stop_now = (torch.sigmoid(logits.float()) > e.stop_threshold).any(-1)
            stop_now = stop_now & (st.pos >= e.min_steps) & run
            st.stopped = st.stopped | stop_now
            st.pos = torch.where(run, st.pos + 1, st.pos)
            st.prev_mel = torch.where(run[:, None, None], mel[:, -1:, :],
                                      st.prev_mel)
            mels.append(mel)
            runs.append(run)
        mels = torch.stack(mels, 1).reshape(-1, n_frames, cfg.num_mel_bins)
        frame_valid = torch.stack(runs, 1).repeat_interleave(r, dim=1)
        return mels, frame_valid

    @torch.no_grad()
    def _vocode(self, mels, n_frames: int):
        """Postnet + vocoder + smoother over the chunk with left context."""
        pre = self.ecfg.pre_frames
        full = torch.cat([self.state.mel_ctx, mels], dim=1)  # [B, pre+C, M]
        refined = st5.postnet(self.params, self.cfg, full)
        if isinstance(self.voc_cfg, gl.GriffinLimConfig):
            audio = gl.apply(self.voc_params, self.voc_cfg, refined)
        else:
            audio = hfg.apply(self.voc_params, self.voc_cfg, refined)
        if self.amd_params is not None:
            acfg = dataclasses.replace(self.amd_cfg, chunk_frames=n_frames,
                                       pre_frames=pre, post_frames=0)
            chunk_audio = amd.apply(self.amd_params, acfg, refined, audio)
        else:
            chunk_audio = audio[:, pre * self.voc_cfg.total_upsample:]
        return chunk_audio, full[:, -pre:, :]

    # -- public API -----------------------------------------------------------

    def warmup(self) -> None:
        """Run every join batch size and chunk size once up front, so the
        first real session sees steady-state latency."""
        for m in (1, 2, 4, 8):
            if m > self.ecfg.batch_slots:
                break
            for _ in range(m):
                self.start_session(
                    np.zeros(4, np.int32),
                    np.zeros(self.cfg.speaker_embedding_dim, np.float32),
                    lambda a: None, max_frames=sum(self.ecfg.chunk_schedule))
            while self.step():
                pass

    def close(self) -> None:
        """Stop the async harvest thread (no-op in sync mode)."""
        if self._async:
            self._hq.put(None)
            self._hthread.join(timeout=2.0)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.sessions) if s is None]

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.sessions if s is not None)

    def start_session(self, input_ids: np.ndarray, speaker_emb: np.ndarray,
                      callback: Callable[[Optional[np.ndarray]], None],
                      max_frames: Optional[int] = None) -> int:
        """Queue a session; it joins at the next ``step()``.  Returns its id.

        ``callback(audio_chunk | None)``: float32 mono at ``sample_rate``;
        ``None`` marks end of stream.  Never touches the engine-state lock.
        """
        with self._sub_lock:
            sid = self._next_sid
            self._next_sid += 1
            self._pending.append((sid, input_ids, speaker_emb, callback,
                                  max_frames, time.monotonic()))
            return sid

    def _flush_joins_locked(self) -> None:
        free = self.free_slots()
        with self._sub_lock:
            n = min(len(self._pending), len(free), 8)
            entries = [self._pending.popleft() for _ in range(n)]
        ok = []
        for sid, input_ids, speaker_emb, callback, max_frames, t_enq in entries:
            try:
                ia = np.asarray(input_ids, np.int32).reshape(-1)
                sa = np.asarray(speaker_emb, np.float32).reshape(-1)
                if sa.shape[0] != self.cfg.speaker_embedding_dim:
                    raise ValueError(f"speaker dim {sa.shape[0]} != "
                                     f"{self.cfg.speaker_embedding_dim}")
                ok.append((sid, ia, sa, callback, max_frames, t_enq))
            except Exception:  # a poisoned session gets EOS alone
                log.exception("tts join: quarantining poisoned session sid=%s", sid)
                metrics.inc("tts.poisoned_sessions")
                try:
                    callback(None)
                except Exception:
                    log.exception("tts poison EOS callback failed")
        if not ok:
            return
        S = self.ecfg.max_text_tokens
        ids = np.zeros((len(ok), S), np.int64)
        mask = np.zeros((len(ok), S), np.int64)
        spk = np.stack([e[2] for e in ok])
        for i, e in enumerate(ok):
            k = min(len(e[1]), S)
            ids[i, :k] = e[1][:k]
            mask[i, :k] = 1
        dev = self.device
        now = time.monotonic()
        self._join_many(free[:len(ok)], torch.from_numpy(ids).to(dev),
                        torch.from_numpy(mask).to(dev),
                        torch.from_numpy(spk).to(dev))
        for i, (sid, _, _, callback, max_frames, t_enq) in enumerate(ok):
            metrics.observe("tts.queue_wait", now - t_enq)
            self.sessions[free[i]] = _Session(
                sid, free[i], callback,
                max_frames or self.ecfg.max_steps * self.cfg.reduction_factor)

    def abort_all(self, reason: str = "engine failure") -> None:
        """Supervision hook: flush EOS to every live and queued session and
        reset the engine state so the next call starts clean."""
        with self._lock:
            victims = [s for s in self.sessions if s is not None]
            with self._sub_lock:
                pend = list(self._pending)
                self._pending.clear()
            self.sessions = [None] * self.ecfg.batch_slots
            self._inflight = None
            self._last_dispatch_t = None
            self.state = self._init_state()
        log.warning("tts engine abort (%s): EOS to %d live + %d queued",
                    reason, len(victims), len(pend))
        for cb, sid in ([(s.callback, s.sid) for s in victims]
                        + [(item[3], item[0]) for item in pend]):
            try:
                cb(None)
            except Exception:
                log.exception("tts abort EOS callback failed (sid=%s)", sid)

    def cancel_session(self, sid: int) -> None:
        """Barge-in: stop generating for this session (lock-free flag)."""
        for s in list(self.sessions):
            if s is not None and s.sid == sid:
                s.cancelled = True
                return
        with self._sub_lock:
            for item in list(self._pending):
                if item[0] == sid:
                    self._pending.remove(item)
                    item[3](None)
                    return

    def pause_session(self, sid: int) -> None:
        """Flow control: freeze this session's decode until resumed."""
        self._set_paused(sid, True)

    def resume_session(self, sid: int) -> None:
        self._set_paused(sid, False)

    def _set_paused(self, sid: int, value: bool) -> None:
        for s in list(self.sessions):
            if s is not None and s.sid == sid:
                s.paused = value
                return

    def step(self) -> bool:
        """Run one emission for all live sessions; deliver the previous
        tick's audio (sync mode) or hand the tick to the harvest thread
        (async mode).  Returns True while any session is live or queued."""
        if not self._async:
            with self._lock:
                return self._step_locked()
        # async mode: bounded dispatch pipeline + harvest thread.  Acquire
        # the inflight budget OUTSIDE the lock (the harvest thread needs the
        # lock to release it).
        if not self._sem.acquire(timeout=1.0):
            # pipeline full for a whole second (slow fetch): do NOT dispatch
            # past the inflight budget; in-flight ticks imply pending work
            return True
        item = None
        try:
            with self._lock:
                item = self._dispatch_locked()
        finally:
            if item is None:
                self._sem.release()
        if item is None:
            # nothing runnable: wait for in-flight ticks to drain so EOS
            # callbacks land before we report idle
            with self._idle_cv:
                self._idle_cv.wait_for(lambda: self._inflight_n == 0,
                                       timeout=1.0)
            with self._lock:
                return self.n_active > 0 or len(self._pending) > 0
        with self._idle_cv:
            self._inflight_n += 1
        self._hq.put(item)
        return True

    def _harvest_loop(self) -> None:
        while True:
            item = self._hq.get()
            if item is None:
                return
            try:
                item[0].get()  # waits on the tick's own event, lock-free
                with self._lock:
                    self._harvest(*item)
            except Exception:
                log.exception("tts harvest failed")
            self._sem.release()
            with self._idle_cv:
                self._inflight_n -= 1
                self._idle_cv.notify_all()

    def _step_locked(self) -> bool:
        item = self._dispatch_locked()
        if item is None:
            # drain the pipelined tick so the last sessions complete
            if self._inflight is not None:
                self._harvest(*self._inflight)
                self._inflight = None
            return self.n_active > 0 or len(self._pending) > 0
        # one-tick pipeline: dispatch tick N, then harvest tick N-1 while
        # the device computes tick N
        prev, self._inflight = self._inflight, item
        if prev is not None:
            self._harvest(*prev)
        return True

    @torch.no_grad()
    def _dispatch_locked(self):
        self._flush_joins_locked()
        runnable = [s for s in self.sessions if s is not None and not s.paused]
        if not runnable:
            return None
        sched = self.ecfg.chunk_schedule
        youngest = min(s.chunks_recv for s in runnable)
        n_frames = sched[min(youngest, len(sched) - 1)]
        paused = np.array([s is not None and s.paused for s in self.sessions])
        mels, frame_valid = self._decode_chunk(
            torch.from_numpy(paused).to(self.device), n_frames)
        audio, new_ctx = self._vocode(mels, n_frames)
        ran_any = frame_valid.any(dim=1)  # paused/idle slots keep their ctx
        self.state.mel_ctx = torch.where(ran_any[:, None, None], new_ctx,
                                         self.state.mel_ctx)
        self.tick_frames.append(n_frames)
        now = time.monotonic()
        if self._last_dispatch_t is not None:
            self.tick_ms.append((now - self._last_dispatch_t) * 1e3)
            metrics.observe("tts.tick_s", now - self._last_dispatch_t)
        self._last_dispatch_t = now
        return HostFetch(audio.float(), frame_valid), n_frames, list(self.sessions), paused

    def _harvest(self, fetch: HostFetch, n_frames, snapshot,
                 paused_at_dispatch) -> None:
        """Deliver one tick to the sessions live at its dispatch."""
        audio_np, valid_np = fetch.get()
        fs = self.voc_cfg.total_upsample
        for slot, sess in enumerate(snapshot):
            if sess is None or self.sessions[slot] is not sess:
                continue
            if paused_at_dispatch[slot] and not sess.cancelled:
                continue  # flow-controlled: no frames, not an EOS
            if sess.cancelled:
                sess.callback(None)
                self.sessions[slot] = None
                self._leave(slot)
                continue
            raw_valid = int(valid_np[slot].sum())
            nvalid = min(raw_valid, sess.max_frames - sess.frames_sent)
            sess.chunks_recv += 1
            if nvalid > 0:
                if sess.t_first is None:
                    sess.t_first = time.monotonic()
                    metrics.observe("tts.ttfb", sess.t_first - sess.t_start)
                # a copy: the tick's (pinned) buffer is not kept alive
                sess.callback(audio_np[slot, : nvalid * fs].copy())
                sess.frames_sent += nvalid
                metrics.inc("tts.audio_samples", nvalid * fs)
            # run flags are monotone: a partial chunk means the stop fired
            if raw_valid < n_frames or sess.frames_sent >= sess.max_frames:
                metrics.observe("tts.session_s", time.monotonic() - sess.t_start)
                sess.callback(None)
                self.sessions[slot] = None
                self._leave(slot)
        # queued sessions join in a batched dispatch at the next step
        metrics.set("tts.active_slots", self.n_active)
