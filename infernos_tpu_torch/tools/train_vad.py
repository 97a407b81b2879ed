"""Train the NeuralVAD on synthetic telephone audio, on the card.

Port of ``tools/train_vad.py``: batches of windowed speech-over-noise with
exact per-window labels (``audio/synth_speech.py`` ``make_example``, the same
for the same numpy seed), the network run over each sequence's windows with
its LSTM state carried from window to window (:func:`seq_apply`, the
reference's ``lax.scan``), a mean binary cross-entropy and AdamW at a
constant rate.  Nothing on that path cuts the graph: ``models/vad.apply``
returns a new state and writes none in place (only ``NeuralVAD``, the
serving wrapper, runs without grad).  fp32 on every device, as the
reference trains (``tools/optim.py``).

    python -m infernos_tpu_torch.tools.train_vad [--steps 1500] [--batch 48]
        [--windows 12] [--lr 1e-3] [--seed 42] [--eval-only] [--out DIR]
        [--device cpu]

Writes ``vad_weights.npz`` to ``--out`` (default
``infernos_tpu_torch/build/trained/vad``; never inside ``infernos_tpu/``),
which ``models.vad.load_pretrained(device, path)`` reads.  Then the held-out
window accuracy against the energy VAD.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List

import numpy as np
import torch

from ..audio.synth_speech import SR, make_example
from ..models import vad as vad_m
from ..models.npz_io import save_params
from ..utils.platform import default_device
from . import optim

WEIGHTS = "vad_weights.npz"


def make_batch(rng, batch: int, n_windows: int, window: int):
    """[B, T, W] audio windows + [B, T] labels."""
    xs, ys = [], []
    seconds = n_windows * window / SR
    for _ in range(batch):
        a, l = make_example(rng, seconds, window)
        xs.append(a.reshape(n_windows, window))
        ys.append(l[:n_windows])
    return np.stack(xs), np.stack(ys)


def seq_apply(params, cfg, windows, state):
    """``apply`` over the time axis, the state carried. windows: [B, T, W]
    -> (probs [B, T], final state)."""
    probs = []
    for t in range(windows.shape[1]):
        p, state = vad_m.apply(params, cfg, windows[:, t], state)
        probs.append(p)
    return torch.stack(probs, dim=1), state


def loss_fn(p, cfg: vad_m.VADConfig, windows, labels):
    """The reference trainer's loss: the mean BCE of every window's speech
    probability, from a zero state; -> (loss, probs)."""
    st = vad_m.init_state(cfg, windows.shape[0], windows.device)
    probs, _ = seq_apply(p, cfg, windows, st)
    probs = probs.float()
    eps = 1e-6
    bce = -(labels * torch.log(probs + eps) + (1 - labels) * torch.log(1 - probs + eps))
    return bce.mean(), probs.detach()


def make_optimizer(params, lr: float) -> optim.AdamW:
    return optim.AdamW(optim.leaves(params), lr, weight_decay=1e-5)


def train(params, cfg, opt: optim.AdamW, next_batch: Callable[[int], tuple],
          steps: int, device, log_every: int = 100) -> List[float]:
    last = {}

    def batch(step):
        last["labels"] = (b := next_batch(step))[1]
        return optim.to_device(b, device)

    def report(step, loss, probs):
        acc = float(((probs.cpu().numpy() > 0.5) == last["labels"]).mean())
        return f"step {step:5d} loss {loss:.4f} acc {acc:.3f}"

    return optim.fit(loss_fn, params, opt, cfg, batch, steps,
                     log_every=log_every, report=report)


def save(out: str, params) -> str:
    path = os.path.join(optim.check_out(out), WEIGHTS)
    save_params(path, params)
    return path


@torch.no_grad()
def held_out(params, cfg, seed: int, device) -> tuple:
    """Window accuracy of the network and of ``EnergyVAD`` on 64 fresh
    sequences of 24 windows."""
    rng = np.random.default_rng(seed + 1)
    n = 64
    xw, yl = make_batch(rng, n, 24, cfg.window)
    probs, _ = seq_apply(params, cfg, torch.from_numpy(xw).to(device),
                         vad_m.init_state(cfg, n, device))
    acc_n = float(((probs.float().cpu().numpy() > 0.5) == yl).mean())
    ev = vad_m.EnergyVAD(n)
    e_preds = np.stack([ev(xw[:, t]) for t in range(xw.shape[1])], axis=1)
    acc_e = float((e_preds == yl).mean())
    print(f"held-out window accuracy: neural {acc_n:.3f}  energy {acc_e:.3f}")
    return acc_n, acc_e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--windows", type=int, default=12)  # ~1.15 s sequences
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--out", default=optim.default_out("vad"))
    ap.add_argument("--device", default=None, help="cpu for the plain path")
    a = ap.parse_args(argv)
    out = optim.check_out(a.out)
    device = default_device(a.device)

    cfg = vad_m.VADConfig()
    rng = np.random.default_rng(a.seed)
    if a.eval_only:
        params = vad_m.load_pretrained(device, os.path.join(out, WEIGHTS))
        if params is None:
            raise SystemExit(f"no trained weights in {out}")
    else:
        params = optim.trainable(vad_m.init_params(
            cfg, torch.Generator().manual_seed(a.seed), device))
        train(params, cfg, make_optimizer(params, a.lr),
              lambda step: make_batch(rng, a.batch, a.windows, cfg.window), a.steps, device)
        path = save(out, params)
        print("saved", path, f"{os.path.getsize(path) / 1e6:.2f} MB")
        params = vad_m.load_pretrained(device, path)
    held_out(params, cfg, a.seed, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
