"""Train the tiny-but-real SpeechT5-config TTS and its HiFi-GAN vocoder on
the synthetic spoken language (``audio/speechlang.py``), on the card.

Port of ``tools/train_tiny_tts.py``, both stages:

- SpeechT5 with two-pass scheduled sampling (pass 1 teacher-forced, pass 2
  fed pass 1's predictions at a ramping share of positions), guided
  attention on the cross-attention and an upweighted stop BCE;
- HiFi-GAN with a multi-resolution STFT loss (spectral convergence plus
  log magnitude at FFT sizes 512, 1024 and 2048), its input normalisation
  taken from the data.

The prenet's consistent dropout and the scheduled-sampling draw come from
an explicit ``torch.Generator`` (the reference draws them from
``jax.random``); :func:`t5_loss` also takes them injected, which the
parity test does with the reference's own draws.  No kernel is on this
path: SpeechT5 trains through the teacher-forced ``decode_full``, in fp32
on every device, as the reference trains (``tools/optim.py``).

    python -m infernos_tpu_torch.tools.train_tiny_tts [--steps 3000]
        [--voc-steps 3000] [--batch 32] [--voc-batch 16] [--lr 3e-4]
        [--voc-lr 2e-4] [--seed 0] [--part t5|voc|all] [--out DIR]
        [--device cpu]

Writes ``t5_params.npz``, ``speakers.npz``, ``config.json``,
``voc_params.npz``, ``voc_config.json``, ``corpus.json`` and
``tokenizer/spiece.model`` to ``--out`` (default
``infernos_tpu_torch/build/trained/tiny_tts``; never inside
``infernos_tpu/``): ``INFERNOS_TINY_DATA_TINY_TTS=DIR`` serves it through
``load_tiny_tts``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.mel import mel_filterbank
from ..audio.speechlang import SR, WORDS, Speaker, render_text, transcript_corpus
from ..models import hifigan as hfg
from ..models import speecht5 as st5
from ..models.npz_io import save_params
from ..models.spm import SentencePieceModel, save_spm_model, train_char_spm
from ..utils.platform import default_device
from . import optim
from .train_tiny_stt import DataServer

N_MELS = 80
N_FFT = 1024
HOP = 256          # = hifigan total_upsample; 16 ms per frame @ 16 k
MAX_TEXT = 48
MAX_FRAMES = 320   # mel frames (~5.1 s); decoder steps = /reduction_factor
N_SPEAKERS = 32
SPK_DIM = 64
CROP = 64          # vocoder training crop, mel frames (= 16384 samples)
STFT_SIZES = ((512, 128), (1024, 256), (2048, 512))


def speaker_bank():
    return [Speaker.random(np.random.default_rng(7000 + i))
            for i in range(N_SPEAKERS)]


def mel80_np(wav: np.ndarray) -> np.ndarray:
    """[T_samples] -> [T_frames, 80] log10-mel (hop 256, win 1024 @16 k)."""
    n = (len(wav) // HOP) * HOP
    x = np.pad(wav[:n], (N_FFT // 2, N_FFT // 2), mode="reflect")
    n_frames = n // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT))
    frames = x[idx] * win[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    fb = mel_filterbank(N_MELS, N_FFT, SR, fmax=8000.0)
    mel = spec @ fb.T
    return np.log10(np.maximum(mel, 1e-7)).astype(np.float32)


def tiny_config(vocab: int) -> st5.SpeechT5Config:
    return st5.SpeechT5Config(
        vocab_size=vocab, hidden_size=256, encoder_layers=3,
        encoder_attention_heads=4, encoder_ffn_dim=768, decoder_layers=3,
        decoder_attention_heads=4, decoder_ffn_dim=768, num_mel_bins=N_MELS,
        reduction_factor=2, speech_decoder_prenet_layers=2,
        speech_decoder_prenet_units=128, speech_decoder_prenet_dropout=0.2,
        speech_decoder_postnet_layers=3, speech_decoder_postnet_units=128,
        speaker_embedding_dim=SPK_DIM, max_text_positions=MAX_TEXT,
        max_speech_positions=MAX_FRAMES)


def voc_config() -> hfg.HifiGanConfig:
    return hfg.HifiGanConfig(
        model_in_dim=N_MELS, upsample_initial_channel=128,
        upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
        resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))


def build_tokenizer() -> SentencePieceModel:
    return train_char_spm(transcript_corpus(2000, seed=11))


def make_example(rng: np.random.Generator, tok: SentencePieceModel, speakers) -> tuple:
    """(ids, spk_id, mel [T,80], audio)."""
    words = transcript_corpus(1, seed=int(rng.integers(1 << 31)))[0]
    sid = int(rng.integers(0, N_SPEAKERS))
    while True:
        audio = render_text(rng, words, speakers[sid])
        if len(audio) <= MAX_FRAMES * HOP:
            break
        words = " ".join(words.split()[:-1])
    mel = mel80_np(audio)
    ids = tok.encode(words)[:MAX_TEXT]
    return ids, sid, mel, audio


def assemble(examples):
    """(toks, tmask, spk, mels, fmask, stops): mels padded at their floor,
    frames a multiple of the reduction factor, stop on the last group."""
    B = len(examples)
    toks = np.zeros((B, MAX_TEXT), np.int32)
    tmask = np.zeros((B, MAX_TEXT), np.float32)
    spk = np.zeros((B,), np.int32)
    mels = np.zeros((B, MAX_FRAMES, N_MELS), np.float32)
    fmask = np.zeros((B, MAX_FRAMES), np.float32)
    stops = np.zeros((B, MAX_FRAMES), np.float32)
    for i, (ids, sid, mel, _audio) in enumerate(examples):
        toks[i, : len(ids)] = ids
        tmask[i, : len(ids)] = 1.0
        spk[i] = sid
        T = min(mel.shape[0], MAX_FRAMES)
        T -= T % 2
        mels[i, :T] = mel[:T]
        mels[i, T:] = mel[:T].min()  # pad at the mel floor, not 0
        fmask[i, :T] = 1.0
        stops[i, T - 2 :] = 1.0  # stop fires on the last group onward
    return toks, tmask, spk, mels, fmask, stops


def voc_batch(rng: np.random.Generator, examples):
    """(mels [B, CROP, 80], wavs [B, CROP * HOP]): a random aligned crop of
    each example, or the whole of a short one, zero-padded."""
    mels = np.zeros((len(examples), CROP, N_MELS), np.float32)
    wavs = np.zeros((len(examples), CROP * HOP), np.float32)
    for i, (_, _, mel, audio) in enumerate(examples):
        T = min(mel.shape[0], len(audio) // HOP)
        if T <= CROP:
            mels[i, :T] = mel[:T]
            wavs[i, : T * HOP] = audio[: T * HOP]
        else:
            o = int(rng.integers(0, T - CROP))
            mels[i] = mel[o : o + CROP]
            wavs[i] = audio[o * HOP : (o + CROP) * HOP]
    return mels, wavs


def p_ss(step: int, steps: int) -> float:
    """Scheduled-sampling share: teacher forcing for the first quarter,
    then a ramp to 50% predicted frames."""
    return min(0.5, max(0.0, (step / steps - 0.25) / 0.75) * 0.5)


# -- SpeechT5 -----------------------------------------------------------------------

def draw(cfg: st5.SpeechT5Config, batch: int, share: float,
         generator: torch.Generator, device):
    """One step's random draws: the two passes' prenet dropout masks (one
    ``[Td, units]`` keep mask per prenet layer) and the scheduled-sampling
    choice ``[B, Td - 1, 1]`` (1.0 = feed the prediction)."""
    Td = MAX_FRAMES // cfg.reduction_factor
    masks = [st5.prenet_dropout_masks(cfg, Td, generator, device) for _ in range(2)]
    u = torch.rand((batch, Td - 1, 1), generator=generator, device=generator.device)
    return masks[0], masks[1], (u < share).float().to(device)


def t5_loss(p, cfg: st5.SpeechT5Config, toks, tmask, spk, mels, fmask, stops, draws):
    """The reference's two-pass loss (``tools/train_tiny_tts.py:206-270``):
    L1 of both passes' mels before and after the postnet, the stop BCE with
    positives weighted 5, and guided attention; -> (loss, (pre, post,
    stop, ga))."""
    masks1, masks2, use_pred = draws
    r = cfg.reduction_factor
    enc = st5.encode_text(p, cfg, toks, attention_mask=tmask)
    B, T = mels.shape[:2]
    Td = T // r
    prev = mels[:, r - 1 :: r][:, : Td - 1]
    zero = torch.zeros((B, 1, N_MELS), dtype=mels.dtype, device=mels.device)
    gt_in = torch.cat([zero, prev], 1)
    spk_emb = p["spk_table"][spk.long()]
    offset = torch.zeros((B,), dtype=torch.long, device=mels.device)

    def fwd(mel_in, masks):
        dec_in = st5.decoder_prenet(p, cfg, mel_in, spk_emb, step_offset=offset,
                                    dropout_masks=masks)
        hid, xattn = st5.decode_full(p, cfg, dec_in, enc, enc_mask=tmask,
                                     return_cross_attn=True)
        mel_b, stop_logits = st5.feat_and_prob(p, cfg, hid)
        return mel_b, st5.postnet(p, cfg, mel_b), stop_logits, xattn

    mel_b1, mel_a1, _, _ = fwd(gt_in, masks1)
    pred_prev = mel_a1.detach().reshape(B, Td, r, N_MELS)[:, : Td - 1, r - 1]
    mix_prev = pred_prev * use_pred + prev * (1.0 - use_pred)
    mel_b, mel_a, stop_logits, xattn = fwd(torch.cat([zero, mix_prev.to(mels.dtype)], 1),
                                           masks2)
    fm = fmask[:, :, None]
    denom = fmask.sum().clamp_min(1.0)
    # guided attention: cross-attention mass far from the diagonal
    gmask = fmask[:, r - 1 :: r]                                    # [B, Td]
    td_len = gmask.sum(-1, keepdim=True).clamp_min(1.0)
    s_len = tmask.sum(-1, keepdim=True).clamp_min(1.0)
    t_pos = torch.arange(Td, dtype=torch.float32, device=mels.device)[None, :] / td_len
    s_pos = torch.arange(toks.shape[1], dtype=torch.float32,
                         device=mels.device)[None, :] / s_len
    dist = t_pos[:, :, None] - s_pos[:, None, :]                  # [B, Td, S]
    wga = 1.0 - torch.exp(-(dist * dist) / (2.0 * 0.2 ** 2))
    vmask = gmask[:, :, None] * tmask[:, None, :].float()
    ga_num = (xattn.float() * (wga * vmask)[None, :, None]).sum()
    l_ga = ga_num / (gmask.sum() * xattn.shape[0] * xattn.shape[2]).clamp_min(1.0)

    def l1(m):
        return ((m.float() - mels).abs() * fm).sum() / (denom * N_MELS)

    l_b, l_a, l_b1, l_a1 = l1(mel_b), l1(mel_a), l1(mel_b1), l1(mel_a1)
    sl = optim.sigmoid_binary_cross_entropy(stop_logits, stops)
    l_s = (sl * (1.0 + 4.0 * stops) * fmask).sum() / denom
    loss = l_b + l_a + 0.5 * (l_b1 + l_a1) + 0.5 * l_s + 2.0 * l_ga
    return loss, (l_b, l_a, l_s, l_ga)


def init_t5(cfg: st5.SpeechT5Config, seed: int, device):
    """SpeechT5 from a seed, with the learned speaker table (N(0, 0.1))."""
    g = torch.Generator().manual_seed(seed)
    params = st5.init_params(cfg, g, device)
    params["spk_table"] = 0.1 * torch.randn((N_SPEAKERS, SPK_DIM), generator=g).to(device)
    return params


def t5_optimizer(params, lr: float, steps: int) -> optim.AdamW:
    return optim.AdamW(optim.leaves(params),
                       optim.cosine_decay_schedule(lr, steps, alpha=0.05),
                       weight_decay=1e-4)


def train_t5(params, cfg, opt: optim.AdamW, next_batch: Callable[[int], tuple],
             steps: int, device, seed: int = 0, log_every: int = 100,
             draws: Optional[Callable[[int, float], tuple]] = None) -> List[float]:
    """``steps`` updates in place on ``next_batch(step)``'s numpy batches;
    ``draws(step, share)`` gives a step's draws (default: a generator seeded
    ``seed + 99``).  Returns the losses."""
    gen = torch.Generator().manual_seed(seed + 99)

    def batch(step):
        share = p_ss(step, steps)
        b = optim.to_device(next_batch(step), device)
        return (*b, draws(step, share) if draws else draw(cfg, b[0].shape[0], share, gen, device))

    def report(step, loss, aux):
        lb, la, ls, lg = (float(x) for x in aux)
        return (f"t5 step {step} loss {loss:.4f} (pre {lb:.4f} post {la:.4f} stop {ls:.4f} "
                f"ga {lg:.4f} ss {p_ss(step, steps):.2f})")

    return optim.fit(t5_loss, params, opt, cfg, batch, steps, log_every=log_every,
                     report=report)


# -- vocoder ------------------------------------------------------------------------

def stft_mag(x, n_fft: int, hop: int):
    """[B, T] -> [B, F, n_fft//2+1] magnitudes, framed as the reference's
    ``_stft_mag``: reflect-pad n_fft/2, ``1 + (T' - n_fft) // hop`` frames,
    periodic Hann."""
    pad = n_fft // 2
    x = F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    win = torch.from_numpy((0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
                           .astype(np.float32)).to(x.device)
    return torch.fft.rfft(x.unfold(-1, n_fft, hop) * win, dim=-1).abs()


def voc_loss(p, vcfg: hfg.HifiGanConfig, mel, wav):
    """Multi-resolution STFT loss (``tools/train_tiny_tts.py:328-340``)."""
    pred = hfg.apply(p, vcfg, mel)
    total = 0.0
    for n_fft, hop in STFT_SIZES:
        mp, mt = stft_mag(pred, n_fft, hop), stft_mag(wav, n_fft, hop)
        sc = torch.linalg.vector_norm(mt - mp) / torch.linalg.vector_norm(mt).clamp_min(1e-6)
        lm = (torch.log(mt.clamp_min(1e-5)) - torch.log(mp.clamp_min(1e-5))).abs().mean()
        total = total + sc + lm
    total = total + 10.0 * (pred.float() - wav).abs().mean() * 0.0
    return total, None


def init_vocoder(vcfg: hfg.HifiGanConfig, seed: int, examples, device):
    """HiFi-GAN from a seed, its input normalisation from ``examples``'
    mels."""
    params = hfg.init_params(vcfg, torch.Generator().manual_seed(seed + 17), device)
    cat = np.concatenate([m for (_, _, m, _) in examples], axis=0)
    params["mean"] = torch.from_numpy(cat.mean(axis=0)).to(device)
    params["scale"] = torch.from_numpy(cat.std(axis=0) + 1e-4).to(device)
    return params


def voc_optimizer(params, lr: float, steps: int) -> optim.AdamW:
    return optim.AdamW(optim.leaves(params),
                       optim.cosine_decay_schedule(lr, steps, alpha=0.05),
                       weight_decay=1e-5)


def train_vocoder(params, vcfg, opt: optim.AdamW, next_batch: Callable[[int], tuple],
                  steps: int, device, log_every: int = 100) -> List[float]:
    return optim.fit(voc_loss, params, opt, vcfg,
                     lambda step: optim.to_device(next_batch(step), device), steps,
                     log_every=log_every,
                     report=lambda step, loss, _: f"voc step {step} loss {loss:.4f}")


# -- saving -------------------------------------------------------------------------

def save_common(out: str, tok: SentencePieceModel) -> str:
    out = optim.check_out(out)
    os.makedirs(os.path.join(out, "tokenizer"), exist_ok=True)
    save_spm_model(tok, os.path.join(out, "tokenizer", "spiece.model"))
    with open(os.path.join(out, "corpus.json"), "w") as f:
        json.dump({"words": WORDS}, f)
    return out


def save_t5(out: str, params, cfg: st5.SpeechT5Config) -> None:
    out = optim.check_out(out)
    params = dict(params)
    table = params.pop("spk_table").detach().float().cpu().numpy()
    save_params(os.path.join(out, "t5_params.npz"), params)
    np.savez(os.path.join(out, "speakers.npz"), table=table)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, f, indent=2)


def save_vocoder(out: str, params, vcfg: hfg.HifiGanConfig) -> None:
    out = optim.check_out(out)
    save_params(os.path.join(out, "voc_params.npz"), params)
    with open(os.path.join(out, "voc_config.json"), "w") as f:
        json.dump({k: getattr(vcfg, k) for k in vcfg.__dataclass_fields__},
                  f, indent=2, default=list)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--voc-steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--voc-batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--voc-lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--part", choices=["t5", "voc", "all"], default="all")
    ap.add_argument("--out", default=optim.default_out("tiny_tts"))
    ap.add_argument("--device", default=None, help="cpu for the plain path")
    a = ap.parse_args(argv)
    out = optim.check_out(a.out)
    device = default_device(a.device)

    tok = build_tokenizer()
    speakers = speaker_bank()
    server = DataServer(None, seed=a.seed + 1, size=1536, ready=192,
                        make=lambda rng: make_example(rng, tok, speakers))
    try:
        save_common(out, tok)
        if a.part in ("t5", "all"):
            cfg = tiny_config(tok.vocab_size)
            params = optim.trainable(init_t5(cfg, a.seed, device))
            rng = np.random.default_rng(a.seed)
            train_t5(params, cfg, t5_optimizer(params, a.lr, a.steps),
                     lambda step: assemble(server.sample(rng, a.batch)), a.steps,
                     device, a.seed)
            save_t5(out, params, cfg)
            print(f"saved t5 to {out}")
        if a.part in ("voc", "all"):
            vcfg = voc_config()
            params = optim.trainable(init_vocoder(
                vcfg, a.seed, server.sample(np.random.default_rng(a.seed + 3), 64), device))
            rng = np.random.default_rng(a.seed + 23)
            train_vocoder(params, vcfg, voc_optimizer(params, a.voc_lr, a.voc_steps),
                          lambda step: voc_batch(rng, server.sample(rng, a.voc_batch)),
                          a.voc_steps, device)
            save_vocoder(out, params, vcfg)
            print(f"saved vocoder to {out}")
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
