"""Train the tiny-but-real Whisper-config STT on the synthetic spoken
language (``audio/speechlang.py``), on the card.

Port of ``tools/train_tiny_stt.py``: the same tokenizer (byte-level BPE
with no merges and the serving prompt's specials), the same config, the
same examples and batches (bit for bit, for the same numpy seed), the
same loss (``whisper.encode`` + ``decode_full``, cross-entropy on the sot
position and the text) and the same AdamW with a linear warmup and cosine
decay.  The encoder's self-attention runs the attention kernel on the
card (``ops/attention.py``), with the reference's backward
(``KernelAttention``, the kernel's fp32 mode); parameters, AdamW state and
the forward are fp32 on every device, as the reference trains
(``tools/optim.py``).

    python -m infernos_tpu_torch.tools.train_tiny_stt [--steps 7000]
        [--batch 32] [--lr 3e-4] [--eval-only] [--resume] [--seed 0]
        [--out DIR] [--device cpu]

Writes ``params.npz``, ``config.json``, ``special_tokens.json``,
``corpus.json`` and ``tokenizer/{vocab.json,merges.txt}`` to ``--out``
(default ``infernos_tpu_torch/build/trained/tiny_stt``; never inside
``infernos_tpu/``), the layout ``models/tiny_real.load_tiny_stt`` reads:
``INFERNOS_TINY_DATA_TINY_STT=DIR`` serves it.  Then the held-out word
accuracy per language side.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..audio.mel import log_mel_np
from ..audio.speechlang import SR, WORDS, make_utterance, transcript_corpus
from ..models import whisper as wsp
from ..models.bpe import ByteLevelBPE, train_bpe
from ..models.npz_io import load_params, save_params
from ..utils.platform import default_device
from . import optim

N_MELS = 80
MAX_SECONDS = 5.0
MAX_MEL_T = int(MAX_SECONDS * SR) // 160          # 500 frames
MAX_TGT = 48

# the serving prompt's specials, in the reference trainer's order
SPECIALS = ["<|sot|>", "<|eos|>", "<|nospeech|>", "<|pad|>",
            "<|lang_en|>", "<|transcribe|>", "<|notimestamps|>",
            "<|startofprev|>", "<|lang_pt|>"]


def build_tokenizer() -> ByteLevelBPE:
    """Byte-level BPE with no merges (one token per letter gesture)."""
    corpus = transcript_corpus(3000, seed=7)
    return train_bpe(corpus, vocab_size=256, special_tokens=SPECIALS)


def tiny_config(tok: ByteLevelBPE) -> wsp.WhisperConfig:
    return wsp.WhisperConfig(
        vocab_size=tok.vocab_size, num_mel_bins=N_MELS, d_model=256,
        encoder_layers=2, encoder_attention_heads=4, decoder_layers=2,
        decoder_attention_heads=4, ffn_dim=768,
        max_source_positions=MAX_MEL_T // 2, max_target_positions=64,
        eos_token_id=tok.special["<|eos|>"],
        sot_token_id=tok.special["<|sot|>"],
        no_speech_token_id=tok.special["<|nospeech|>"])


def serving_prompt(tok: ByteLevelBPE, ctx=None, lang: str = "en") -> List[int]:
    """The STT engine's transcribe prompt: ``[<|startofprev|> ctx...] <|sot|>
    <|lang_XX|> <|transcribe|> <|notimestamps|>``."""
    sp = tok.special
    prompt = []
    if ctx:
        prompt = [sp["<|startofprev|>"]] + list(ctx)
    return prompt + [sp["<|sot|>"], sp[f"<|lang_{lang}|>"],
                     sp["<|transcribe|>"], sp["<|notimestamps|>"]]


def _noise(rng: np.random.Generator, seconds: float) -> np.ndarray:
    kind = rng.integers(0, 3)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    if kind == 0:
        x = rng.standard_normal(n)
    elif kind == 1:
        x = np.sin(2 * np.pi * rng.uniform(200, 3000) * t)
        x += 0.2 * rng.standard_normal(n)
    else:
        x = 0.02 * rng.standard_normal(n)  # near-silence
    peak = np.abs(x).max() + 1e-9
    return (0.5 * x / peak).astype(np.float32)


def telephone_channel(audio16: np.ndarray) -> np.ndarray:
    """The serving path's channel: 16k -> 8k -> G.711 mu-law -> 8k -> 16k."""
    from ..audio.codecs import G711Codec
    from ..audio.resample import resample

    codec = G711Codec()
    a8 = resample(audio16, 16000, 8000)
    a8 = codec.decode(codec.encode(a8))
    return resample(np.asarray(a8, np.float32).reshape(-1), 8000, 16000)


def make_example(rng: np.random.Generator, tok: ByteLevelBPE):
    """(mel [M, T], ids, sot_idx, is_silence): 8% noise labelled no-speech;
    45% pure en, 45% pure pt (tagged truthfully), 10% mixed with a random
    tag; 20% of speech with a previous transcript as context; half through
    the telephone channel."""
    sp = tok.special
    is_silence = rng.random() < 0.08
    r = rng.random()
    lang = "en" if r < 0.45 else ("pt" if r < 0.9 else None)
    tag = lang or ("en" if rng.random() < 0.5 else "pt")
    ctx = None
    if not is_silence and rng.random() < 0.2:
        prev = transcript_corpus(1, seed=int(rng.integers(1 << 31)))[0]
        ctx = tok.encode(prev)[:10]
    while True:
        if is_silence:
            audio, text = _noise(rng, float(rng.uniform(0.5, 3.0))), ""
        else:
            audio, text = make_utterance(rng, n_words=(1, 4), lang=lang)
        prompt = serving_prompt(tok, ctx, lang=tag)
        ids = prompt + tok.encode(text) + [sp["<|eos|>"]]
        if (len(audio) <= int(MAX_SECONDS * SR) - 320
                and len(ids) <= MAX_TGT):
            break
        ctx = None  # retry shorter
    if rng.random() < 0.5:
        audio = telephone_channel(audio)
    mel = log_mel_np(audio, N_MELS)[0]
    sot_idx = len(prompt) - 4
    return mel, ids, sot_idx, is_silence


def assemble(examples, tok: ByteLevelBPE):
    """(mel [B,M,T], toks [B,L], tgt [B,L-1], mask [B,L-1]): the sot
    position predicts the language tag (or no-speech), the prompt inside is
    unsupervised, the text and eos are supervised."""
    sp = tok.special
    pad = sp["<|pad|>"]
    batch = len(examples)
    mels = np.zeros((batch, N_MELS, MAX_MEL_T), np.float32)
    toks = np.full((batch, MAX_TGT), pad, np.int32)
    tgt = np.full((batch, MAX_TGT - 1), pad, np.int32)
    mask = np.zeros((batch, MAX_TGT - 1), np.float32)
    for i, (m, ids, sot_idx, is_sil) in enumerate(examples):
        mels[i, :, : m.shape[1]] = m
        toks[i, : len(ids)] = ids
        tgt[i, : len(ids) - 1] = ids[1:]
        mask[i, sot_idx] = 1.0
        if is_sil:
            tgt[i, sot_idx] = sp["<|nospeech|>"]
        first_text = sot_idx + 3  # input pos of <|nots|> predicts 1st text tok
        mask[i, first_text : len(ids) - 1] = 1.0
    return mels, toks, tgt, mask


def make_batch(rng: np.random.Generator, tok: ByteLevelBPE, batch: int):
    return assemble([make_example(rng, tok) for _ in range(batch)], tok)


class DataServer:
    """A replay buffer that worker threads refill with fresh examples; once
    full, each refill sleeps ``refresh_sleep`` so that synthesis leaves the
    host to the training loop."""

    def __init__(self, tok: ByteLevelBPE, seed: int, size: int = 2048,
                 workers: int = 4, refresh_sleep: float = 0.1,
                 make: Optional[Callable] = None, ready: int = 256):
        self.tok = tok
        self.size = size
        self.ready = ready
        self.refresh_sleep = refresh_sleep
        self.make = make or (lambda rng: make_example(rng, tok))
        self.buf: list = []
        self.lock = threading.Lock()
        self.stop = False
        self.generated = 0
        self.threads = [
            threading.Thread(target=self._fill, args=(seed + 31 * i,),
                             daemon=True)
            for i in range(workers)]
        for t in self.threads:
            t.start()

    def _fill(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not self.stop:
            ex = self.make(rng)
            with self.lock:
                full = len(self.buf) >= self.size
                if not full:
                    self.buf.append(ex)
                else:
                    self.buf[int(rng.integers(0, self.size))] = ex
                self.generated += 1
            if full:
                time.sleep(self.refresh_sleep)

    def sample(self, rng: np.random.Generator, batch: int) -> list:
        while True:
            with self.lock:
                if len(self.buf) >= max(batch, self.ready):
                    idx = rng.integers(0, len(self.buf), size=batch)
                    return [self.buf[i] for i in idx]
            time.sleep(0.1)

    def batch(self, rng: np.random.Generator, batch: int):
        return assemble(self.sample(rng, batch), self.tok)

    def close(self) -> None:
        self.stop = True
        for t in self.threads:
            t.join()


# -- the step ---------------------------------------------------------------------

def loss_fn(p, cfg: wsp.WhisperConfig, mel, toks, tgt, mask):
    """The reference trainer's loss: masked mean cross-entropy of the
    teacher-forced decoder over the encoded mel."""
    enc = wsp.encode(p, cfg, mel.to(p["conv1"]["w"].dtype))
    logits = wsp.decode_full(p, cfg, toks[:, :-1], enc)
    ll = optim.softmax_cross_entropy_with_integer_labels(logits, tgt)
    return (ll * mask).sum() / mask.sum().clamp_min(1.0), None


def schedule(lr: float, steps: int):
    warm = min(300, max(1, steps // 10))
    return optim.warmup_cosine_decay_schedule(0.0, lr, warm, steps, lr * 0.02)


def make_optimizer(params, lr: float, steps: int) -> optim.AdamW:
    return optim.AdamW(optim.leaves(params), schedule(lr, steps), weight_decay=1e-4)


def train(params, cfg, opt: optim.AdamW, next_batch: Callable[[int], tuple],
          steps: int, device, log_every: int = 100,
          on_step: Optional[Callable[[int, float], None]] = None) -> List[float]:
    """``steps`` updates of ``params`` in place on ``next_batch(step)``'s
    numpy batches; returns the losses."""
    return optim.fit(loss_fn, params, opt, cfg,
                     lambda step: optim.to_device(next_batch(step), device), steps,
                     log_every=log_every, on_step=on_step)


def save(out: str, params, cfg: wsp.WhisperConfig, tok: ByteLevelBPE) -> None:
    """The layout ``load_tiny_stt`` reads (fp32 leaves)."""
    out = optim.check_out(out)
    os.makedirs(os.path.join(out, "tokenizer"), exist_ok=True)
    with open(os.path.join(out, "corpus.json"), "w") as f:
        json.dump({"words": WORDS}, f)
    save_params(os.path.join(out, "params.npz"), params)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, f, indent=2)
    tok.save(os.path.join(out, "tokenizer", "vocab.json"),
             os.path.join(out, "tokenizer", "merges.txt"))
    with open(os.path.join(out, "special_tokens.json"), "w") as f:
        json.dump(tok.special, f, indent=2)


# -- eval -------------------------------------------------------------------------

@torch.no_grad()
def greedy_decode(params, cfg, tok, mel, max_new: int = MAX_TGT - 1,
                  lang: str = "en", device="cpu") -> List[str]:
    """Batched greedy from the serving prompt over a fixed ``[B, MAX_TGT]``
    token buffer (the decoder is causal: positions past the frontier do not
    change its logits)."""
    B = mel.shape[0]
    prompt = serving_prompt(tok, lang=lang)
    P = len(prompt)
    enc = wsp.encode(params, cfg, torch.from_numpy(mel).to(device).to(params["conv1"]["w"].dtype))
    buf = np.full((B, MAX_TGT), cfg.eos_token_id, np.int32)
    buf[:, :P] = prompt
    done = np.zeros(B, bool)
    for t in range(P, min(MAX_TGT, P + max_new)):
        logits = wsp.decode_full(params, cfg, torch.from_numpy(buf).to(device), enc)
        nxt = logits[:, t - 1].float().argmax(-1).cpu().numpy().astype(np.int32)
        nxt = np.where(done, cfg.eos_token_id, nxt)
        buf[:, t] = nxt
        done |= nxt == cfg.eos_token_id
        if done.all():
            break
    outs = []
    for row in buf:
        ids = []
        for tkn in row[P:]:
            if tkn == cfg.eos_token_id:
                break
            ids.append(int(tkn))
        outs.append(tok.decode(ids))
    return outs


def word_acc(hyps, refs) -> float:
    """The share of the references' words that the hypotheses match in place."""
    ok = tot = 0
    for h, r in zip(hyps, refs):
        hw, rw = h.split(), r.split()
        tot += len(rw)
        ok += sum(1 for a, b in zip(hw, rw) if a == b)
    return ok / max(1, tot)


def held_out(params, cfg, tok, seed: int, device, n: int = 12) -> dict:
    """Word accuracy per language side on fresh utterances."""
    erng = np.random.default_rng(seed + 10_000)
    accs = {}
    for lang in ("en", "pt"):
        texts, mels = [], []
        while len(texts) < n:
            audio, text = make_utterance(erng, n_words=(1, 4), lang=lang)
            if len(audio) > int(MAX_SECONDS * SR) - 320:
                continue
            if erng.random() < 0.5:
                audio = telephone_channel(audio)
            texts.append(text)
            mels.append(log_mel_np(audio, N_MELS)[0])
        mel = np.zeros((len(texts), N_MELS, MAX_MEL_T), np.float32)
        for i, m in enumerate(mels):
            mel[i, :, : m.shape[1]] = m
        hyps = greedy_decode(params, cfg, tok, mel, lang=lang, device=device)
        accs[lang] = word_acc(hyps, texts)
        print(f"held-out {lang} word accuracy: {accs[lang]:.3f}")
        for h, r in list(zip(hyps, texts))[:3]:
            print(f"  ref: {r!r}\n  hyp: {h!r}")
    return accs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=7000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="continue from OUT/params.npz (warm-restart schedule)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=optim.default_out("tiny_stt"))
    ap.add_argument("--device", default=None, help="cpu for the plain path")
    a = ap.parse_args(argv)
    out = optim.check_out(a.out)
    device = default_device(a.device)

    tok = build_tokenizer()
    cfg = tiny_config(tok)
    rng = np.random.default_rng(a.seed)
    path = os.path.join(out, "params.npz")
    params = None
    if a.eval_only or a.resume:
        params = load_params(path, device, torch.float32)
        if a.eval_only and params is None:
            raise SystemExit(f"no checkpoint at {out}")
    if not a.eval_only:
        if params is None:
            params = wsp.init_params(cfg, torch.Generator().manual_seed(a.seed), device)
        else:
            print(f"resuming from {path}", flush=True)
        params = optim.trainable(params)
        opt = make_optimizer(params, a.lr, a.steps)
        server = DataServer(tok, seed=a.seed + 1)

        def checkpoint(step, _loss):
            if step and step % 1000 == 0:
                save(out, params, cfg, tok)  # a resumable partial checkpoint

        try:
            train(params, cfg, opt, lambda step: server.batch(rng, a.batch),
                  a.steps, device, on_step=checkpoint)
        finally:
            server.close()
        save(out, params, cfg, tok)
        print(f"saved to {out}")
    held_out(params, cfg, tok, a.seed, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
