"""LLM serving engine: continuous-batched decode with sentence streaming.

Port of ``infernos_tpu/serving/llm_engine.py`` with the same semantics:
ChatML prompts (:func:`apply_chat_template`), streamed generation flushed on
sentence boundaries (``. ? ! \\n`` past a minimum length) so the TTS starts
speaking mid-generation, and slot-batched decode with per-slot positions:
a request is prefilled in its prompt bucket (truncated to the bucket's last
tokens), joins a free slot, and frees it the moment it ends.

- A decode dispatch runs ``steps_per_dispatch`` greedy steps eagerly on
  device tensors with no host sync inside; a slot that emits EOS inside the
  window freezes on the device (position and token stay put, its cache
  writes are dropped).
- Each step writes its K/V rows in place at the slot's position
  (``models/qwen.py``).  The reference drops a finished slot's write by
  aiming it at column ``Tmax`` and relies on its scatter to discard it;
  torch raises on such a row, so the write is masked instead, and so is
  any row past ``Tmax`` (deep pipelines decode past a slot's budget).
- ``max_inflight`` dispatches stay in flight before the oldest is
  harvested; ``spec_decode`` verifies n-gram drafts in one pass
  (``qwen.verify_steps``) and harvests first, as the reference does.
- A harvest fetches through pinned buffers and a CUDA event, never a
  ``.cpu()``: the engine shares the process, and the stream, with the STT
  and TTS engines, and a stream-wide wait would wait on their kernels too.
- Submitters take ``_sub_lock`` only; the stepping thread holds ``_lock``.

``LLMEngineConfig.decode_unroll`` (an XLA scan unroll) is not ported.
Tensor parallelism: ``LLMEngine(..., mesh=)`` with a ``tp`` mesh
(``parallel/mesh.py``), one engine per rank.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import qwen
from ..utils.logging import get_logger
from ..utils.metrics import metrics
from ..utils.platform import default_device
from .fetch import HostFetch

log = get_logger("serving.llm")

SENTENCE_CHARS = ".?!\n"  # reference flush set, InfernLLMWorker.py:17
MIN_SENTENCE_CHARS = 10


@dataclasses.dataclass(frozen=True)
class LLMEngineConfig:
    batch_slots: int = 8  # reference batch, Cluster/InfernLLMWorker.py
    prompt_buckets: Sequence[int] = (128, 256, 512, 1024)
    max_total_tokens: int = 2048
    max_new_tokens: int = 1024
    dtype: Any = torch.float32
    # decode steps per dispatch: sentence streaming granularity becomes K
    # tokens, invisible behind the >=10-char flush
    steps_per_dispatch: int = 4
    # speculative decode (n-gram self-drafting): each dispatch verifies
    # spec_k-1 drafted tokens in one pass and emits 1..spec_k tokens;
    # replaces steps_per_dispatch when enabled
    spec_decode: bool = False
    spec_k: int = 8          # tokens per verify pass (draft = spec_k - 1)
    spec_ngram: int = 3      # longest suffix n-gram to match for drafting
    # decode dispatches kept in flight before the oldest is harvested (EOS
    # detection lags max_inflight*K tokens; harvest caps emission, so
    # outputs are unchanged).  Ignored in spec mode, which harvests before
    # drafting.
    max_inflight: int = 1


@dataclasses.dataclass
class LLMRequest:
    """One generation request over a full chat context."""

    prompt_ids: np.ndarray  # already-templated token ids
    sentence_cb: Callable[[str, bool], None]  # (text, is_final)
    max_new_tokens: Optional[int] = None
    stime: float = dataclasses.field(default_factory=time.monotonic)


class _SentenceStreamer:
    """Incremental detokenize + flush on sentence boundaries (>= min chars)."""

    def __init__(self, detokenize: Callable[[List[int]], str],
                 cb: Callable[[str, bool], None]):
        self.detok = detokenize
        self.cb = cb
        self.tokens: List[int] = []
        self.flushed_chars = 0

    def push(self, tok: int) -> None:
        self.tokens.append(tok)
        text = self.detok(self.tokens)
        pending = text[self.flushed_chars:]
        cut = -1
        for i in range(len(pending) - 1, -1, -1):
            if pending[i] in SENTENCE_CHARS and i + 1 >= MIN_SENTENCE_CHARS:
                cut = i
                break
        if cut >= 0:
            out = pending[: cut + 1].strip()
            if out:
                self.cb(out, False)
            self.flushed_chars += cut + 1

    def finish(self) -> None:
        text = self.detok(self.tokens)
        rest = text[self.flushed_chars:].strip()
        self.cb(rest, True)


class _Slot:
    __slots__ = ("req", "streamer", "new_tokens", "prompt_len")

    def __init__(self, req, streamer, prompt_len):
        self.req = req
        self.streamer = streamer
        self.new_tokens = 0
        self.prompt_len = prompt_len


class LLMEngine:
    def __init__(self, params: Dict[str, Any], cfg: qwen.QwenConfig,
                 ecfg: LLMEngineConfig = LLMEngineConfig(),
                 detokenize: Optional[Callable[[List[int]], str]] = None,
                 eos_ids: Optional[Sequence[int]] = None,
                 device=None, mesh=None):
        """``params`` must already live on ``device`` (the card unless the
        caller asks for the CPU) in the types the caller serves.

        ``mesh``: a ``tp`` mesh (``parallel.make_mesh(t, axes=("tp",))``)
        for tensor parallelism, one engine per rank, on the mesh's device.
        ``params`` are already this rank's shards (``parallel.mesh.shard``
        under ``qwen.param_shardings``, or ``quant.quantize_shardings`` of
        a tree quantized whole), and the KV cache holds this rank's
        ``num_kv_heads/t`` heads (``qwen.cache_shardings``), so decode
        attention stays local and each layer sums over the group twice.
        Every rank must run the same host program: the same submits in the
        same order, stepped by one thread.  The greedy argmax reads the
        gathered logits, which every rank holds alike (each sum hands all
        ranks the same values), so every rank takes the same tokens and
        the slots' host state stays in lockstep; a rank that strays hangs
        a collective until the group's timeout fails it.  The path is
        eager: a gloo collective cannot be captured in a CUDA graph."""
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"LLMEngine: device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = default_device(device)
        self.mesh = mesh
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.detokenize = detokenize or (lambda toks: " ".join(map(str, toks)) + " ")
        self.eos_ids = set(eos_ids or [cfg.eos_token_id])
        dev = self.device
        self._layers = qwen.layer_list(params)
        self._eos = torch.tensor(sorted(self.eos_ids), device=dev)
        B = ecfg.batch_slots
        self.cache = qwen.init_cache(qwen.shard_config(cfg, mesh), B,
                                     ecfg.max_total_tokens, dtype=ecfg.dtype,
                                     device=dev)
        self.pos = torch.zeros(B, dtype=torch.long, device=dev)
        self.cur_tok = torch.zeros(B, dtype=torch.long, device=dev)
        self.done = torch.ones(B, dtype=torch.bool, device=dev)
        self.slots: List[Optional[_Slot]] = [None] * B
        # engine-state lock: held by the stepping thread for whole steps;
        # submitters never wait on it, they go through _sub_lock only
        self._lock = threading.RLock()
        # pipelined (fetch, slot-snapshot) pairs not yet harvested, oldest
        # first; at most ecfg.max_inflight entries after each step()
        self._inflight = deque()
        self._sub_lock = threading.Lock()  # guards _pending only
        self._pending = deque()  # requests waiting to join

    # -- device programs ------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr)).long()
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.no_grad()
    def _prefill_bucket(self, tokens: torch.Tensor, prompt_len: int):
        logits, ks, vs = qwen.prefill(self.params, self.cfg, tokens,
                                      layers=self._layers, mesh=self.mesh)
        # argmax on the device: the host fetches one token, not a row
        first_tok = logits[0, prompt_len - 1].argmax()
        return first_tok, ks.to(self.ecfg.dtype), vs.to(self.ecfg.dtype)

    @torch.no_grad()
    def _join(self, slot: int, ks, vs, prompt_len: int, first_tok) -> None:
        P = ks.shape[3]
        for c, new in ((self.cache.k, ks), (self.cache.v, vs)):
            c[:, slot, :, :P] = new[:, 0]
            c[:, slot, :, P:] = 0
        self.pos[slot] = prompt_len
        self.cur_tok[slot] = first_tok
        self.done[slot] = False

    @torch.no_grad()
    def _step(self) -> torch.Tensor:
        """K greedy steps in one dispatch; returns per-step tokens [B, K]."""
        Tmax = self.cache.k.shape[3]
        pos, cur_tok, done = self.pos, self.cur_tok, self.done
        outs = []
        for _ in range(self.ecfg.steps_per_dispatch):
            logits, _ = qwen.decode_step(self.params, self.cfg, cur_tok, self.cache,
                                         pos, write=~done & (pos < Tmax),
                                         layers=self._layers, mesh=self.mesh)
            nxt = logits.argmax(dim=-1)
            # freeze a slot on the device once it emits EOS inside this
            # window (the host still owns the slot's lifecycle)
            new_done = done | torch.isin(nxt, self._eos)
            pos = torch.where(done, pos, pos + 1)
            cur_tok = torch.where(new_done, cur_tok, nxt)
            done = new_done
            outs.append(nxt)
        self.pos, self.cur_tok = pos, cur_tok
        return torch.stack(outs, dim=1)

    @torch.no_grad()
    def _verify(self, draft: torch.Tensor):
        """One speculative verify dispatch: draft [B, K-1] candidate
        continuations after cur_tok.  Returns (pred [B, K], n_emit [B]):
        ``pred[i, :n_emit[i]]`` are slot i's newly decoded tokens (the
        accepted draft prefix and one correction)."""
        B = self.cur_tok.shape[0]
        done = self.done
        tokens_in = torch.cat([self.cur_tok[:, None], draft], dim=1)
        logits, _ = qwen.verify_steps(self.params, self.cfg, tokens_in, self.cache,
                                      self.pos, write=~done, layers=self._layers,
                                      mesh=self.mesh)
        pred = logits.argmax(dim=-1)  # [B, K]
        matches = (pred[:, :-1] == draft).long()
        a = matches.cumprod(dim=1).sum(dim=1)  # leading matches
        n_emit = torch.where(done, torch.zeros_like(a), a + 1)
        self.pos = self.pos + n_emit
        new_cur = pred[torch.arange(B, device=pred.device), a]
        self.cur_tok = torch.where(done, self.cur_tok, new_cur)
        return pred, n_emit

    # -- speculative drafting -------------------------------------------------

    def _ngram_draft(self, s) -> np.ndarray:
        """Prompt-lookup drafting over the slot's OWN generated tokens: the
        longest (<= spec_ngram) suffix that re-occurred earlier predicts the
        tokens that followed it; falls back to repeating the last token."""
        K1 = self.ecfg.spec_k - 1
        hist = s.streamer.tokens
        draft = np.zeros(K1, np.int64)
        if not hist:
            return draft
        draft[:] = hist[-1]
        for n in range(min(self.ecfg.spec_ngram, len(hist) - 1), 0, -1):
            suffix = hist[-n:]
            for idx in range(len(hist) - n - 1, -1, -1):
                if hist[idx:idx + n] == suffix:
                    cont = hist[idx + n: idx + n + K1]
                    if cont:
                        draft[: len(cont)] = cont
                        return draft
                    break
            else:
                continue
            break
        return draft

    # -- public API -----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def warmup(self) -> None:
        """Run every bucket's prefill and one decode dispatch (all slots
        done, so nothing is written), then wait for them (reference warm-up
        trick, ``Cluster/InfernLLMActor.py:30-40``)."""
        with self._lock:
            for n in self.ecfg.prompt_buckets:
                self._prefill_bucket(self._to_device(np.zeros((1, n), np.int64)), 1)
            if self.ecfg.spec_decode:
                self._verify(torch.zeros((self.ecfg.batch_slots, self.ecfg.spec_k - 1),
                                         dtype=torch.long, device=self.device))
            else:
                self._step()
            HostFetch(self.pos).get()

    def abort_all(self, reason: str = "engine failure") -> None:
        """Supervision hook: flush a final (possibly partial) result to every
        live and queued request and reset slot state, so callers waiting on
        a final sentence are never stranded."""
        with self._lock:
            victims = [s for s in self.slots if s is not None]
            with self._sub_lock:
                pend = list(self._pending)
                self._pending.clear()
            self.slots = [None] * self.ecfg.batch_slots
            self._inflight.clear()
            self.done = torch.ones_like(self.done)
        log.warning("llm engine abort (%s): flushing %d live + %d queued",
                    reason, len(victims), len(pend))
        for s in victims:
            try:
                s.streamer.finish()  # emits whatever was generated, final=True
            except Exception:
                log.exception("llm abort flush failed")
        for req in pend:
            try:
                req.sentence_cb("", True)
            except Exception:
                log.exception("llm abort flush failed (queued)")

    def submit(self, req: LLMRequest) -> int:
        """Queue one request; the stepping thread prefills and joins it at
        its next step.  Returns -1 (queued).  Never touches the engine-state
        lock."""
        with self._sub_lock:
            self._pending.append(req)
        return -1

    def _flush_pending_locked(self, max_joins: int = 4) -> None:
        """Join queued requests into free slots (stepping thread, under
        _lock); capped per step so prefills interleave with decode."""
        joined = 0
        while joined < max_joins and self.free_slots():
            with self._sub_lock:
                if not self._pending:
                    return
                req = self._pending.popleft()
            # a poisoned request finishes alone (empty stream) instead of
            # crashing the step for every slot
            try:
                self._submit_locked(req)
                joined += 1
            except Exception:
                log.exception("llm: quarantining poisoned queued request")
                metrics.inc("llm.poisoned_requests")
                try:
                    _SentenceStreamer(self.detokenize, req.sentence_cb).finish()
                except Exception:
                    log.exception("llm poison EOS callback failed")

    def _submit_locked(self, req: LLMRequest) -> int:
        slot = self.free_slots()[0]
        ids = np.asarray(req.prompt_ids, np.int64)
        bucket = next((b for b in self.ecfg.prompt_buckets if len(ids) <= b),
                      self.ecfg.prompt_buckets[-1])
        ids = ids[-bucket:]
        plen = len(ids)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = ids
        first_tok_d, ks, vs = self._prefill_bucket(self._to_device(padded), plen)
        self._join(slot, ks, vs, plen, first_tok_d)
        first_tok = int(HostFetch(first_tok_d).get()[0])
        streamer = _SentenceStreamer(self.detokenize, req.sentence_cb)
        s = _Slot(req, streamer, plen)
        self.slots[slot] = s
        if first_tok in self.eos_ids:
            self._finish(slot, s)
        else:
            streamer.push(first_tok)
            s.new_tokens = 1
        return slot

    def step(self) -> bool:
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> bool:
        self._flush_pending_locked()
        if self.n_active == 0:
            if self._inflight:
                self._harvest(*self._inflight.popleft())
                # keep the driver hot while trailing dispatches remain
                return (self.n_active > 0 or bool(self._inflight)
                        or bool(self._pending))
            return bool(self._pending)
        if self.ecfg.spec_decode:
            # harvest first: drafts must end at the device's actual cur_tok
            while self._inflight:
                self._harvest(*self._inflight.popleft())
            if self.n_active == 0:
                return bool(self._pending)
            draft = np.zeros((self.ecfg.batch_slots, self.ecfg.spec_k - 1),
                             np.int64)
            for i, s in enumerate(self.slots):
                if s is not None:
                    draft[i] = self._ngram_draft(s)
            fetch = HostFetch(*self._verify(self._to_device(draft)))
        else:
            fetch = HostFetch(self._step())
        # software pipeline: dispatch N, harvest N-max_inflight while the
        # device computes (the AR feedback stays on the device)
        self._inflight.append((fetch, list(self.slots)))
        while len(self._inflight) > max(1, self.ecfg.max_inflight):
            self._harvest(*self._inflight.popleft())
        return True

    def _harvest(self, fetch: HostFetch, snapshot) -> None:
        got = fetch.get()
        pred_np = got[0]  # [B, K]
        nemit_np = got[1] if self.ecfg.spec_decode else None
        K = pred_np.shape[1]
        for i, s in enumerate(snapshot):
            if s is None or self.slots[i] is not s:
                continue
            limit = s.req.max_new_tokens or self.ecfg.max_new_tokens
            budget = self.ecfg.max_total_tokens - s.prompt_len - 1
            cap = min(limit, budget)
            n_take = K if nemit_np is None else int(nemit_np[i])
            if nemit_np is not None:
                metrics.observe("llm.spec_emit", float(n_take))
            fin = False
            for k in range(n_take):
                tok = int(pred_np[i, k])
                if tok in self.eos_ids or s.new_tokens >= cap:
                    fin = True
                    break
                s.streamer.push(tok)
                s.new_tokens += 1
            if fin:
                self._finish(i, s)
        # EOS detection is host-side only, so device ``done`` is exactly
        # slot emptiness (a request _finish just joined stays live)
        done = torch.tensor([s is None for s in self.slots])
        if self.device.type == "cuda":
            done = done.pin_memory().to(self.device, non_blocking=True)
        self.done = done

    def _finish(self, slot: int, s: _Slot) -> None:
        self.slots[slot] = None
        # backfill the freed slot immediately (stepping thread, one join)
        self._flush_pending_locked(max_joins=1)
        metrics.observe("llm.gen_time", time.monotonic() - s.req.stime)
        metrics.inc("llm.tokens", s.new_tokens)
        s.streamer.finish()


# -- chat templating -----------------------------------------------------------

IM_START, IM_END = "<|im_start|>", "<|im_end|>"


def apply_chat_template(messages: List[Dict[str, str]],
                        add_generation_prompt: bool = True) -> str:
    """Qwen ChatML string template (tokenizer-agnostic)."""
    out = []
    for m in messages:
        out.append(f"{IM_START}{m['role']}\n{m['content']}{IM_END}\n")
    if add_generation_prompt:
        out.append(f"{IM_START}assistant\n")
    return "".join(out)
