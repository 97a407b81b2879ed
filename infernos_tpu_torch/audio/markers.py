"""In-band audio stream markers.

Capability parity with ``Core/AStreamMarkers.py:17-31``: control objects that
travel *through the audio queue* so callbacks fire only when the pacer
actually reaches that point in the stream -- e.g. "sentence N is done playing"
(used to serialize multi-sentence TTS say-queues and app notifications).
"""

from __future__ import annotations

from typing import Callable


class ASMarkerGeneric:
    track_id: int = 0

    def __init__(self, track_id: int = 0):
        self.track_id = track_id


class ASMarkerNewSent(ASMarkerGeneric):
    """Sentence boundary marker."""


class ASMarkerSentDoneCB(ASMarkerNewSent):
    """Fires ``done_cb`` on the pacer thread when the stream drains to it.

    ``sync`` requests the pacer to wait for the callback's completion before
    continuing (the reference optionally ``ray.get``-waits,
    ``Core/AStreamMarkers.py:24-31``; here callbacks are plain callables or
    awaitables resolved by the caller).
    """

    def __init__(self, done_cb: Callable[[], object], sync: bool = False,
                 track_id: int = 0):
        super().__init__(track_id=track_id)
        self.done_cb = done_cb
        self.sync = sync

    def on_proc(self) -> None:
        res = self.done_cb()
        if self.sync and hasattr(res, "result"):
            res.result()  # concurrent.futures.Future
