"""Train the AmendmentNetwork chunk smoother on synthetic boundary
artifacts, on the card.

Port of ``tools/train_amendnet.py``: clean synthetic speech
(``audio/synth_speech.py``) is corrupted with what chunked vocoding leaves
at chunk seams -- a gain step and a DC offset per chunk, boundary clicks --
and the gain-mask net learns to undo them from the clean mel; the same
batches for the same numpy seed, an L1 loss and AdamW at a constant rate.
fp32 on every device, as the reference trains (``tools/optim.py``).

    python -m infernos_tpu_torch.tools.train_amendnet [--steps 1200]
        [--batch 64] [--lr 3e-4] [--seed 42] [--out DIR] [--device cpu]

Writes ``amendnet_weights.npz`` to ``--out`` (default
``infernos_tpu_torch/build/trained/amendnet``; never inside
``infernos_tpu/``), which ``models.amendnet.load_pretrained(device,
path=...)`` reads.  Then the held-out L1 against the identity.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List

import numpy as np
import torch

from ..audio.synth_speech import synth_speech
from ..models import amendnet as amd
from ..models.npz_io import save_params
from ..utils.platform import default_device
from . import optim

SR = 16000
WEIGHTS = "amendnet_weights.npz"


def mel_frames(audio: np.ndarray, n_mels: int, frame: int) -> np.ndarray:
    """Log-mel with hop == frame size, aligned 1:1 with audio frames."""
    n = len(audio) // frame
    win = np.hanning(frame * 2)
    pad = np.concatenate([np.zeros(frame // 2), audio[: n * frame],
                          np.zeros(frame * 2)])
    spec = np.stack([np.abs(np.fft.rfft(pad[i * frame : i * frame + 2 * frame] * win))
                     for i in range(n)])
    nf = spec.shape[1]
    # triangular mel-ish filterbank (log-spaced centers)
    centers = np.geomspace(2, nf - 2, n_mels + 2)
    fb = np.zeros((n_mels, nf), np.float32)
    for m in range(n_mels):
        lo, c, hi = centers[m], centers[m + 1], centers[m + 2]
        f = np.arange(nf)
        fb[m] = np.clip(np.minimum((f - lo) / (c - lo + 1e-9),
                                   (hi - f) / (hi - c + 1e-9)), 0, None)
    return np.log1p(spec @ fb.T).astype(np.float32)  # [n, n_mels]


def corrupt(rng: np.random.Generator, audio: np.ndarray, cfg) -> np.ndarray:
    """Inject chunk-boundary artifacts every ``chunk_frames`` frames."""
    fs, ck = cfg.frame_size, cfg.chunk_frames
    x = audio.copy()
    n_chunks = len(x) // (fs * ck)
    for c in range(n_chunks):
        s = c * fs * ck
        e = s + fs * ck
        g = 10 ** (rng.uniform(-1.5, 1.5) / 20)  # per-chunk gain step
        x[s:e] *= g
        x[s:e] += rng.uniform(-0.02, 0.02)  # DC offset
        if rng.random() < 0.7:  # boundary click / edge ramp
            w = int(rng.integers(8, 48))
            x[s : s + w] += (rng.uniform(-0.3, 0.3)
                             * np.hanning(2 * w)[:w].astype(np.float32))
    return np.clip(x, -1.0, 1.0)


def make_batch(rng, batch: int, cfg):
    """Training windows of (chunk + context) with clean targets."""
    fs, tf, ck, pre = cfg.frame_size, cfg.total_frames, cfg.chunk_frames, cfg.pre_frames
    mels, dirty, clean = [], [], []
    while len(mels) < batch:
        sp, _ = synth_speech(rng, 1.2, sr=SR)
        sp = (0.5 * sp).astype(np.float32)
        bad = corrupt(rng, sp, cfg)
        mel = mel_frames(sp, cfg.num_mels, fs)
        n_frames = min(len(sp) // fs, len(mel))
        max_start = n_frames - tf - 1
        if max_start <= pre:
            continue
        for _ in range(4):
            if len(mels) >= batch:
                break
            st = int(rng.integers(0, max_start // ck)) * ck
            fr = slice(st, st + tf)
            sm = slice(st * fs, (st + tf) * fs)
            mels.append(mel[fr])
            dirty.append(bad[sm])
            cs = (st + pre) * fs
            clean.append(sp[cs : cs + ck * fs])
    return (np.stack(mels), np.stack(dirty), np.stack(clean))


def loss_fn(p, cfg: amd.AmendNetConfig, mel, dirty, clean):
    """The reference trainer's loss: mean L1 of the amended chunk."""
    out = amd.apply(p, cfg, mel, dirty)
    return (out.float() - clean).abs().mean(), None


def make_optimizer(params, lr: float) -> optim.AdamW:
    return optim.AdamW(optim.leaves(params), lr, weight_decay=1e-5)


def train(params, cfg, opt: optim.AdamW, next_batch: Callable[[int], tuple],
          steps: int, device, log_every: int = 100) -> List[float]:
    return optim.fit(loss_fn, params, opt, cfg,
                     lambda step: optim.to_device(next_batch(step), device), steps,
                     log_every=log_every,
                     report=lambda step, loss, _: f"step {step:5d} L1 {loss:.4f}")


def save(out: str, params) -> str:
    path = os.path.join(optim.check_out(out), WEIGHTS)
    save_params(path, params)
    return path


@torch.no_grad()
def held_out(params, cfg, seed: int, device) -> tuple:
    """L1 of the amended chunk and of the corrupted one against the clean."""
    mel, dirty, clean = make_batch(np.random.default_rng(seed + 1), 64, cfg)
    out = amd.apply(params, cfg, *optim.to_device((mel, dirty), device)).float().cpu().numpy()
    fs, pre, ck = cfg.frame_size, cfg.pre_frames, cfg.chunk_frames
    ident = dirty[:, pre * fs : (pre + ck) * fs]
    l1_net = float(np.abs(out - clean).mean())
    l1_id = float(np.abs(ident - clean).mean())
    print(f"held-out L1: amended {l1_net:.4f}  identity {l1_id:.4f} "
          f"({l1_id / max(l1_net, 1e-9):.2f}x better)")
    return l1_net, l1_id


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=optim.default_out("amendnet"))
    ap.add_argument("--device", default=None, help="cpu for the plain path")
    a = ap.parse_args(argv)
    out = optim.check_out(a.out)
    device = default_device(a.device)

    cfg = amd.AmendNetConfig()
    rng = np.random.default_rng(a.seed)
    params = optim.trainable(amd.init_params(cfg, torch.Generator().manual_seed(a.seed),
                                             device))
    train(params, cfg, make_optimizer(params, a.lr),
          lambda step: make_batch(rng, a.batch, cfg), a.steps, device)
    path = save(out, params)
    print("saved", path, f"{os.path.getsize(path) / 1e6:.2f} MB")
    held_out(params, cfg, a.seed, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
