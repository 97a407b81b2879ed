"""Tiered STT serving: short utterances decode against short cross-caches.

The decode step reads every slot's FULL padded cross-K/V each token, so a
3 s utterance in a 30 s-bucket engine pays a 30 s-sized read per step.
Telephony VAD segments are overwhelmingly short (the reference caps segments at 30 s and merges to
<=32 s only opportunistically), so this facade routes:

- utterances <= ``short_max_s`` -> a WIDE short-bucket engine (many slots,
  small cross cache);
- longer utterances -> a narrow 30 s-capable engine.

Both tiers share one stepping thread and ONE parameter tree on the device
(the weights are not copied); the facade exposes the single-engine surface
(``submit/step/n_active/abort_all/warmup/ecfg``) so sessions and actors are
unchanged.  Port of ``infernos_tpu/serving/stt_tiered.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from .stt_engine import STTEngine, STTEngineConfig, STTRequest


@dataclasses.dataclass(frozen=True)
class TieredSTTConfig:
    short_max_s: int = 8
    short_slots: int = 24
    long_slots: int = 8
    dtype: Any = torch.float32
    # forwarded to both tiers
    base: STTEngineConfig = dataclasses.field(default_factory=STTEngineConfig)

    def short_ecfg(self) -> STTEngineConfig:
        return dataclasses.replace(
            self.base, batch_slots=self.short_slots,
            buckets_s=tuple(b for b in self.base.buckets_s
                            if b <= self.short_max_s) or (self.short_max_s,),
            dtype=self.dtype)

    def long_ecfg(self) -> STTEngineConfig:
        return dataclasses.replace(self.base, batch_slots=self.long_slots,
                                   dtype=self.dtype)


class TieredSTTEngine:
    """Two STTEngines behind the single-engine serving surface."""

    def __init__(self, params: Dict[str, Any], cfg,
                 tcfg: TieredSTTConfig = TieredSTTConfig(),
                 detokenize: Optional[Callable[[List[int]], str]] = None,
                 device=None):
        self.tcfg = tcfg
        self.short = STTEngine(params, cfg, tcfg.short_ecfg(),
                               detokenize=detokenize, device=device)
        self.long = STTEngine(params, cfg, tcfg.long_ecfg(),
                              detokenize=detokenize, device=device)
        self.device = self.short.device
        self.detokenize = self.short.detokenize

    # sessions read sample_rate / context bounds off ecfg; expose the long
    # tier's (it is the permissive superset)
    @property
    def ecfg(self) -> STTEngineConfig:
        return self.long.ecfg

    @property
    def n_active(self) -> int:
        return self.short.n_active + self.long.n_active

    def _route(self, req: STTRequest) -> STTEngine:
        limit = self.tcfg.short_max_s * self.short.ecfg.sample_rate
        return self.short if len(req.audio) <= limit else self.long

    def free_slots(self) -> List[Any]:
        """Combined view (tier-tagged); a full tier queues internally, so
        this is a load signal, not a submit precondition."""
        return ([("short", i) for i in self.short.free_slots()]
                + [("long", i) for i in self.long.free_slots()])

    def submit(self, req: STTRequest) -> int:
        return self._route(req).submit(req)

    def step(self) -> bool:
        a = self.short.step()
        b = self.long.step()
        return a or b

    def warmup(self) -> None:
        self.short.warmup()
        self.long.warmup()

    def abort_all(self, reason: str = "engine failure") -> None:
        self.short.abort_all(reason)
        self.long.abort_all(reason)
