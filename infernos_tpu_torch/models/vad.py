"""Voice-activity-detection models with explicit, slot-batched state.

Port of ``infernos_tpu/models/vad.py``.  The model is a plain function
``(params, window[B, W], state) -> (probs[B], state)`` on tensors, with the
reference's parameter key paths (``conv1``, ``conv2``, ``lstm[i].{wi,wh,b}``,
``head``), so a tree taken from the reference maps leaf for leaf.

Interchangeable implementations behind ``[B, W] -> probs [B]``:

- :class:`NeuralVAD`: Silero-class architecture (conv feature frontend +
  2-layer LSTM(64) + sigmoid head) on the card (or on the CPU when asked);
- :class:`NumpyVAD`: the same network in numpy on the host;
- :class:`EnergyVAD`: deterministic adaptive-energy heuristic.

``NeuralVAD`` and ``NumpyVAD`` both take ``slots=`` and then run only the
rows they were given, leaving the LSTM state of every other slot untouched:
an idle channel's state must not advance on zeros while others speak.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.platform import default_device
from . import layers as L


@dataclasses.dataclass(frozen=True)
class VADConfig:
    window: int = 768  # samples per decision @8 kHz
    sample_rate: int = 8000
    n_fft: int = 256
    hop: int = 128
    conv_ch: int = 64
    lstm_hidden: int = 64
    lstm_layers: int = 2


class VADState(NamedTuple):
    h: torch.Tensor  # [layers, B, hidden]
    c: torch.Tensor  # [layers, B, hidden]


def init_state(cfg: VADConfig, batch: int, device) -> VADState:
    shape = (cfg.lstm_layers, batch, cfg.lstm_hidden)
    return VADState(torch.zeros(shape, dtype=torch.float32, device=device),
                    torch.zeros(shape, dtype=torch.float32, device=device))


def init_params(cfg: VADConfig, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict[str, Any]:
    """Seeded random parameters on ``device``."""
    g = generator
    n_bins = cfg.n_fft // 2 + 1
    H = cfg.lstm_hidden
    p: Dict[str, Any] = {
        "conv1": L.conv1d_init(g, n_bins, cfg.conv_ch, 3, device, dtype),
        "conv2": L.conv1d_init(g, cfg.conv_ch, cfg.conv_ch, 3, device, dtype),
        "lstm": [],
        "head": L.linear_init(g, H, 1, device, dtype),
    }
    bound = 1.0 / math.sqrt(H)
    for i in range(cfg.lstm_layers):
        d_in = cfg.conv_ch if i == 0 else H
        p["lstm"].append({
            "wi": L.uniform(g, (d_in, 4 * H), bound, device, dtype),
            "wh": L.uniform(g, (H, 4 * H), bound, device, dtype),
            "b": torch.zeros(4 * H, device=device, dtype=dtype),
        })
    return p


def _lstm_cell(p, x, h, c):
    """Single LSTM step, torch gate order (i, f, g, o)."""
    gates = x @ p["wi"] + h @ p["wh"] + p["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def apply(params, cfg: VADConfig, window, state: VADState
          ) -> Tuple[torch.Tensor, VADState]:
    """window: [B, W] float32 -> (speech probs [B], new state)."""
    _, W = window.shape
    dev = window.device
    n_frames = 1 + (W - cfg.n_fft) // cfg.hop
    idx = (torch.arange(cfg.n_fft, device=dev)[None, :]
           + cfg.hop * torch.arange(n_frames, device=dev)[:, None])
    hann = torch.from_numpy(
        (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(cfg.n_fft) / cfg.n_fft)
         ).astype(np.float32)).to(dev)
    frames = window[:, idx] * hann[None, None, :]
    mag = torch.fft.rfft(frames, dim=-1).abs().float()  # [B, F, bins]
    feat = torch.log1p(mag)
    x = torch.relu(L.conv1d(feat, params["conv1"], padding=1))
    x = torch.relu(L.conv1d(x, params["conv2"], padding=1))  # [B, F, C]

    hs, cs = [], []
    for li, lp in enumerate(params["lstm"]):
        h, c = state.h[li], state.c[li]
        ys = []
        for t in range(x.shape[1]):
            h, c = _lstm_cell(lp, x[:, t], h, c)
            ys.append(h)
        x = torch.stack(ys, dim=1)
        hs.append(h)
        cs.append(c)
    prob = torch.sigmoid(L.linear(x[:, -1], params["head"]))[:, 0]
    return prob, VADState(torch.stack(hs), torch.stack(cs))


def load_pretrained(device, path: Optional[str] = None
                    ) -> Optional[Dict[str, Any]]:
    """The vendored trained VAD weights (read by file path from
    ``infernos_tpu/models/data/vad_weights.npz``) as fp32 tensors on
    ``device``, or None when absent."""
    from .npz_io import data_path, load_params

    return load_params(path or data_path("vad_weights.npz"), device,
                       torch.float32)


class NeuralVAD:
    """Slot-batched neural VAD whose LSTM state lives on the device.

    ``device`` defaults to the card; pass ``device="cpu"`` to run there.
    ``params`` are moved to that device once, here.
    """

    #: the worker passes ``slots`` so that only occupied rows run
    supports_slots = True

    def __init__(self, params, cfg: VADConfig, batch: int, device=None):
        self.device = default_device(device)
        self.cfg = cfg
        self.batch = batch
        from .convert import cast_floating

        self.params = _to_device(cast_floating(params, torch.float32),
                                 self.device)
        self.state = init_state(cfg, batch, self.device)

    @torch.no_grad()
    def __call__(self, windows: np.ndarray,
                 slots: "np.ndarray | None" = None) -> np.ndarray:
        """windows ``[B, W]`` for all slots, or, with ``slots [n]``, ``[n, W]``
        for those slots only (the others' state stays as it is) -> probs."""
        w = torch.from_numpy(np.ascontiguousarray(windows, np.float32)
                             ).to(self.device)
        if slots is None:
            probs, self.state = apply(self.params, self.cfg, w, self.state)
            return probs.cpu().numpy()
        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)
        sub = VADState(self.state.h[:, idx], self.state.c[:, idx])
        probs, new = apply(self.params, self.cfg, w, sub)
        self.state.h[:, idx] = new.h
        self.state.c[:, idx] = new.c
        return probs.cpu().numpy()

    def reset_channel(self, idx: int) -> None:
        self.state.h[:, idx] = 0.0
        self.state.c[:, idx] = 0.0


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class NumpyVAD:
    """Pure-numpy inference for the trained VAD, on the host.

    The net is ~100k params, so numpy runs a forward without any device
    round trip; numerics match :func:`apply` (parity-tested).
    """

    def __init__(self, params, cfg: VADConfig, batch: int):
        self.cfg = cfg
        self.batch = batch
        g = lambda p: np.asarray(p, np.float32)
        self.conv1_w = g(params["conv1"]["w"])  # [K, Cin, Cout]
        self.conv1_b = g(params["conv1"]["b"])
        self.conv2_w = g(params["conv2"]["w"])
        self.conv2_b = g(params["conv2"]["b"])
        self.lstm = [{k: g(v) for k, v in lp.items()} for lp in params["lstm"]]
        self.head_w = g(params["head"]["w"])
        self.head_b = g(params["head"].get("b", np.zeros(1)))
        L_, H = cfg.lstm_layers, cfg.lstm_hidden
        self.h = np.zeros((L_, batch, H), np.float32)
        self.c = np.zeros((L_, batch, H), np.float32)
        n = cfg.n_fft
        self._hann = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)

    @staticmethod
    def _conv1d(x, w, b):
        """x [B,F,Cin], w [3,Cin,Cout], pad 1."""
        xp = np.pad(x, ((0, 0), (1, 1), (0, 0)))
        y = (xp[:, :-2] @ w[0] + xp[:, 1:-1] @ w[1] + xp[:, 2:] @ w[2])
        return y + b

    #: the worker passes ``slots`` to run only the occupied rows, not the
    #: full slot-table width per forward
    supports_slots = True

    def __call__(self, windows: np.ndarray,
                 slots: "np.ndarray | None" = None) -> np.ndarray:
        cfg = self.cfg
        B, W = windows.shape
        n_frames = 1 + (W - cfg.n_fft) // cfg.hop
        idx = (np.arange(cfg.n_fft)[None, :]
               + cfg.hop * np.arange(n_frames)[:, None])
        frames = windows[:, idx] * self._hann[None, None, :]
        feat = np.log1p(np.abs(np.fft.rfft(frames, axis=-1))).astype(np.float32)
        x = np.maximum(self._conv1d(feat, self.conv1_w, self.conv1_b), 0.0)
        x = np.maximum(self._conv1d(x, self.conv2_w, self.conv2_b), 0.0)

        def sig(v):
            return 1.0 / (1.0 + np.exp(-v))

        for li, lp in enumerate(self.lstm):
            h = self.h[li] if slots is None else self.h[li][slots]
            c = self.c[li] if slots is None else self.c[li][slots]
            ys = np.empty((B, x.shape[1], h.shape[-1]), np.float32)
            for t in range(x.shape[1]):
                gates = x[:, t] @ lp["wi"] + h @ lp["wh"] + lp["b"]
                i, f, g_, o = np.split(gates, 4, axis=-1)
                c = sig(f) * c + sig(i) * np.tanh(g_)
                h = sig(o) * np.tanh(c)
                ys[:, t] = h
            if slots is None:
                self.h[li], self.c[li] = h, c
            else:
                self.h[li][slots] = h
                self.c[li][slots] = c
            x = ys
        return sig(x[:, -1] @ self.head_w + self.head_b)[:, 0]

    def reset_channel(self, idx: int) -> None:
        self.h[:, idx] = 0.0
        self.c[:, idx] = 0.0


class EnergyVAD:
    """Adaptive-energy VAD: deterministic, dependency-free, works untrained.

    Tracks a per-channel noise floor (exponential min-follower); a window is
    speech when its RMS exceeds ``floor * ratio`` and an absolute gate.
    """

    def __init__(self, batch: int, floor_init: float = 1e-3, ratio: float = 3.0,
                 abs_gate: float = 0.01, decay: float = 0.995):
        self.floor = np.full(batch, floor_init, np.float32)
        self.ratio = ratio
        self.abs_gate = abs_gate
        self.decay = decay

    def __call__(self, windows: np.ndarray) -> np.ndarray:
        rms = np.sqrt(np.mean(np.square(windows), axis=-1) + 1e-12)
        self.floor = np.minimum(self.floor / self.decay, np.maximum(rms, 1e-5))
        speech = (rms > self.floor * self.ratio) & (rms > self.abs_gate)
        return speech.astype(np.float32)

    def reset_channel(self, idx: int) -> None:
        self.floor[idx] = 1e-3
