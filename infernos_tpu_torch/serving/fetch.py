"""Device results on their way to the host without a stream-wide wait.

The engines share one process, and so one CUDA stream: a ``.cpu()`` of a
result synchronises the whole stream and waits on every other engine's
kernels queued behind it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


class HostFetch:
    """``tensors`` copied to the host.  For CUDA tensors: asynchronous
    copies into pinned buffers, then an event on the current stream;
    :meth:`get` waits on that event alone.  For CPU tensors: the tensors
    themselves."""

    __slots__ = ("host", "event")

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensors[0].device))
            tensors = tuple(host)
        self.host = tensors

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]
