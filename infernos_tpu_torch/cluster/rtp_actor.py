"""RTP actor: owns all media endpoints in this process.

Capability parity with ``Cluster/InfernRTPActor.py``: endpoint dict keyed by
UUID (``:28``), shared ingest ring + batched VAD (``:85-96``), API
``new_rtp_session`` -> (id, local addr) (``:38-42``),
``rtp_session_connect/end/soundout/update``, a thumbstone list so teardown
races are idempotent (``:53-54,62-63,76-78``), and ``get_direct_soundout``
exposing in-process callbacks for bridged leg-to-leg audio that skips the
actor mailbox (``:67-69``).  ``device`` places the ingest ring's VAD: the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Dict, List, Tuple

from ..media.endpoint import RTPEndpoint, RTPParams
from ..media.ingest import AudioInput, RTPIngest
from ..media.udp import RTPPortAllocator
from ..utils.logging import get_logger
from .actors import Actor

log = get_logger("cluster.rtp")


class RTPActor(Actor):
    def __init__(self, min_port: int = 18000, max_port: int = 22000,
                 bind_ip: str = "127.0.0.1", vad_model_factory=None,
                 device=None):
        self.sessions: Dict[uuid_mod.UUID, RTPEndpoint] = {}
        self.thumbstones: List[uuid_mod.UUID] = []
        self.allocator = RTPPortAllocator(min_port, max_port)
        self.bind_ip = bind_ip
        self.ring = RTPIngest(vad_model_factory=vad_model_factory,
                              device=device)

    def on_start(self) -> None:
        self.ring.start()

    def on_stop(self) -> None:
        for ep in list(self.sessions.values()):
            ep.shutdown()
        self.sessions.clear()
        self.ring.stop(join=False)

    # -- session API ----------------------------------------------------------
    def new_rtp_session(self, params: RTPParams) -> Tuple[uuid_mod.UUID, Tuple[str, int]]:
        ep = RTPEndpoint(self.ring, params, self.allocator,
                         bind_ip=self.bind_ip,
                         get_direct_soundout=self._get_direct_soundout)
        self.sessions[ep.id] = ep
        return ep.id, ep.local_addr

    def rtp_session_connect(self, sess_id: uuid_mod.UUID, ain: AudioInput) -> None:
        ep = self.sessions.get(sess_id)
        if ep is None:
            assert sess_id in self.thumbstones
            return
        ep.connect(ain)

    def rtp_session_update(self, sess_id: uuid_mod.UUID, params: RTPParams) -> None:
        ep = self.sessions.get(sess_id)
        if ep is None:
            assert sess_id in self.thumbstones
            return
        ep.update(params)

    def rtp_session_soundout(self, sess_id: uuid_mod.UUID, chunk) -> None:
        ep = self.sessions.get(sess_id)
        if ep is None:
            if sess_id not in self.thumbstones:
                log.warning("soundout to unknown session %s", sess_id)
            return
        ep.soundout(chunk)

    def rtp_session_end(self, sess_id: uuid_mod.UUID, relaxed: bool = False) -> None:
        ep = self.sessions.pop(sess_id, None)
        if ep is None:
            assert relaxed or sess_id in self.thumbstones
            return
        ep.shutdown()
        self.thumbstones.append(sess_id)

    def _get_direct_soundout(self, sess_id: uuid_mod.UUID):
        """In-process fast path for bridged legs (skips the mailbox)."""
        ep = self.sessions.get(sess_id)
        if ep is None:
            # tolerate a race with teardown: emit into the void
            return lambda chunk: None
        return ep.soundout
