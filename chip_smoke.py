#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``infernos_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line:

1. device   -- card name and power limit, TF32 off for the references;
2. build    -- nvcc builds ``infernos_tpu_torch/csrc/*.cu`` (one process
               per source, in parallel);
3. kernel 1 -- encoder attention kernel vs its plain PyTorch version;
4. kernel 2 -- SpeechT5 decoder-step kernel (one cooperative launch per
               step) vs its plain version, with bf16 weights and then
               (``kernel_tts_step_int8``) with int8 weights and
               per-output-channel scales;
5. stt      -- the STT engine at whisper-large-v3 width serves 4 requests;
6. tts      -- the TTS engine at SpeechT5 + HiFi-GAN + AmendNet width
               streams 4 sessions to >= 1 s of audio each;
7. turn     -- one translated turn per channel, four channels, through the
               package's own classes: G.711 mu-law payloads of 20 ms ->
               VADChannel/VADWorker (NeuralVAD on the card) -> STTSession ->
               TieredSTTEngine (large-v3 width) -> translation, numbers to
               words, sentence regrouping -> TTSSession -> TTSEngine over an
               int8-quantized SpeechT5 with async harvest under an
               EngineDriver -> TTSSoundDispatch -> 8 kHz G.711 frames of
               160 bytes;
8. launches -- the kernels and copies the card runs for one
               ``fused_attention`` call (1), one ``fused_decode_step`` call
               in each weight mode (1) and one ``whisper.encode``, counted
               with the profiler, last so that it slows nothing.

Then the ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
Weights are random, from fixed seeds.  Every check that fails raises, so
the script exits non-zero and prints no result line; it never falls back to
the CPU or to a plain version.  Each kernel's launch count is set to 0
right before the path that runs it and read right after.
``--only kernels`` stops after the kernel phases and ``--only attention``
after the first of them (quick build-and-compare runs; they print no result
line).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import threading
import time
from unittest import mock

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate

ATTN_TOL = 1e-2  # bf16 output: the plain version computes in fp32 from the same bf16 inputs
STEP_TOL = 3e-2  # fp32 hidden after 6 layers of bf16 weights; cache rows rounded to bf16
ENC_REL_TOL = 5e-2  # relative L2 error of the 32-layer encoder output, bf16 activations
MEL_REL_TOL = 5e-2  # relative L2 error of one TTS tick's mel chunk (16 chained steps), bf16


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` with the host taken out: ``iters`` calls are
    captured into one CUDA graph and the graph's replay is timed, so a call
    whose launch costs the host more than the kernel costs the card is not
    timed at the host's pace."""
    import torch

    side = torch.cuda.Stream()  # warmed up on the stream that captures
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # builds, sets attributes and warms the allocator and any
    torch.cuda.synchronize()  # per-stream scratch outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, 5, warmup=2) / iters


def profile_window(profile_dir):
    """A ``torch.profiler`` window when ``--profile`` is given, else none."""
    if not profile_dir:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profile_summary(torch, prof, wall_s: float, profile_dir, name: str) -> dict:
    """Kernel time by name (written to ``<dir>/<name>_profile.txt``) and the
    device's busy and idle shares of the window's wall time."""
    if prof is None:
        return {}
    ka = prof.key_averages()
    path = os.path.join(profile_dir, f"{name}_profile.txt")
    with open(path, "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    busy_us = sum(e.self_device_time_total for e in ka
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"profiled_wall_s": wall_s, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s, "profile": path}


def sass_summary(build, name: str):
    """What the compiler made of ``csrc/<name>.cu``: how many instructions,
    warpgroup products (``HGMMA``) and ``mma.sync`` products (``HMMA``) the
    built library holds, and the first ``HGMMA`` line; None without
    ``cuobjdump``."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", os.path.join(build.BUILD_DIR, f"lib{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    ops = [line.split("*/", 1)[1].split(";")[0].strip()
           for line in sass.splitlines() if "*/" in line and ";" in line]
    hgmma = [o for o in ops if o.startswith("HGMMA")]
    return {"instructions": len(ops), "HGMMA": len(hgmma),
            "HMMA": sum(o.startswith("HMMA") for o in ops),
            "first_HGMMA": hgmma[0] if hgmma else None}


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: encoder attention kernel ----------------------------------------

def phase_attention(torch, attn):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(3)
    BH, Dh = 20, 64

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def key_mask(n, S):  # key padding, a different length per row
        lens = torch.randint(S // 2, S + 1, (n,), generator=g, device="cuda")
        return torch.arange(S, device="cuda")[None] < lens[:, None]

    def compare(what, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(math.isfinite(err) and err <= ATTN_TOL,
              f"attention kernel {what}: max abs err {err}")
        return err

    cases = []
    # [BH, S, 64] entry; 128 and 129 sit on the edge of a key tile
    for S in (1500, 250, 401, 128, 129):
        for masked in (False, True):
            q, k, v = rnd(BH, S, Dh), rnd(BH, S, Dh), rnd(BH, S, Dh)
            zeros = torch.zeros((BH, S), device="cuda")
            mask = torch.where(key_mask(BH, S), 0.0, attn.NEG_INF) if masked else None
            got = attn._kernel_attention(q, k, v, mask)  # no mask: a null pointer
            want = attn._plain_attention(q, k, v, zeros if mask is None else mask)
            case = {"S": S, "masked": masked, "max_abs_err": compare(
                f"S={S} masked={masked}", got, want)}
            if S == 1500 and not masked:  # the encoder's shape on the main path
                n_ops = 4.0 * BH * S * S * Dh
                n_bytes = 4 * BH * S * Dh * 2
                # device time (graph replay); eager_ms is the same call made
                # from Python back to back, host-bound if the host is slower
                case["ms"] = graph_ms(lambda: attn._kernel_attention(q, k, v), 50)
                case["eager_ms"] = cuda_ms(lambda: attn._kernel_attention(q, k, v), 50)
                case["plain_ms"] = cuda_ms(lambda: attn._plain_attention(q, k, v, zeros), 10)
                q4, k4, v4 = (t[None] for t in (q, k, v))  # [1, BH, S, Dh]
                sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4)
                case["library_ms"] = graph_ms(sdpa, 50)
                case["library_eager_ms"] = cuda_ms(sdpa, 50)
                case["bound_ms"], case["bound_by"] = bound_ms(n_bytes, n_ops)
            cases.append(case)

    # [B, S, D] entry, heads read in place: B 2 with a key mask per batch
    # element, and the encoder's own call (B 1, S 1500, no mask)
    q, k, v = rnd(2, 700, BH * Dh), rnd(2, 700, BH * Dh), rnd(2, 700, BH * Dh)
    mask = key_mask(2, 700)
    cases.append({"B": 2, "S": 700, "masked": True, "layout": "[B, S, D]",
                  "max_abs_err": compare(
                      "B=2 per-batch mask",
                      attn.fused_attention(q, k, v, n_heads=BH, mask=mask),
                      attn.by_heads(attn._plain_attention, q, k, v, n_heads=BH,
                                    mask=mask))})
    q, k, v = rnd(1, 1500, BH * Dh), rnd(1, 1500, BH * Dh), rnd(1, 1500, BH * Dh)
    fused = lambda: attn.fused_attention(q, k, v, n_heads=BH)
    # the same kernel behind a head split: transposed copies of q, k, v and
    # of the output, and a zero mask repeated per head
    split = lambda: attn.by_heads(attn._kernel_attention, q, k, v, n_heads=BH)
    plain = attn.by_heads(attn._plain_attention, q, k, v, n_heads=BH)
    enc = {"B": 1, "S": 1500, "masked": False, "layout": "[B, S, D]",
           "max_abs_err": compare("[1, 1500, 1280] in place", fused(), plain),
           "split_heads_max_abs_err": compare("[1, 1500, 1280] split", split(), plain),
           "fused_ms": graph_ms(fused, 50), "split_heads_ms": graph_ms(split, 50),
           "fused_eager_ms": cuda_ms(fused, 50),
           "split_heads_eager_ms": cuda_ms(split, 50)}
    cases.append(enc)
    main = next(c for c in cases if "ms" in c)
    emit("kernel_attention", tol=ATTN_TOL, cases=cases,
         bound_us=main["bound_ms"] * 1e3)
    return {"name": "encoder_attention", "route": "cuda",
            "source": "infernos_tpu_torch/csrc/attention.cu",
            "replaces": "infernos_tpu/ops/attention.py:53",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: enc[k] for k in ("fused_ms", "split_heads_ms", "fused_eager_ms",
                                   "split_heads_eager_ms")},
            **{k: main[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_eager_ms")}}


# -- phase 4: TTS decoder-step kernel -----------------------------------------

def step_bytes(fw, cache, pos, B, with_mask=True) -> float:
    """Bytes one step must move: weights and LN/bias params once, each
    slot's self K/V up to its pos, the whole cross K/V, x in, h out."""
    Lyr, _, H, _, Dh = cache.self_k.shape
    S = cache.cross_k.shape[3]
    D = H * Dh
    w = sum(t.numel() * t.element_size() for t in fw.values())
    rows = float((pos.clamp(max=cache.self_k.shape[3] - 1) + 1).sum().item())
    self_kv = 2 * Lyr * H * Dh * 2 * rows
    cross_kv = 2 * Lyr * B * H * S * Dh * 2
    return w + self_kv + cross_kv + (B * S * 4 if with_mask else 0) + 2 * B * D * 4


def step_ops(fw, cache, pos, B) -> float:
    Lyr, _, H, _, Dh = cache.self_k.shape
    S = cache.cross_k.shape[3]
    mats = sum(fw[n].numel() for n in ("wqkv", "wso", "wcq", "wco", "w1", "w2"))
    rows = float((pos.clamp(max=cache.self_k.shape[3] - 1) + 1).sum().item())
    return 2.0 * B * mats + 4.0 * Lyr * H * Dh * (rows + B * S)


def phase_tts_step(torch, st5, ts, int8=False, bf16_ms=None):
    """The decoder-step kernel against its plain version at full width; with
    ``int8`` the weights are quantized first (int8 codes + fp32 scales) and
    the bf16 kernel's time (``bf16_ms``) is printed beside the int8 one.
    Returns the kernels row and the timed call (for the launch count)."""
    from infernos_tpu_torch.models.quant import quantize_params

    cfg = st5.SpeechT5Config()
    g = torch.Generator(device="cuda").manual_seed(4)
    params = st5.init_params(cfg, g, "cuda", torch.bfloat16)
    if int8:
        params = quantize_params(params)
    for n in ("ln1", "ln2", "ln3"):  # init is g=1, b=0: make the affine part count
        ln = params["dec_layers"][n]
        ln["g"] = 1 + 0.1 * torch.randn(ln["g"].shape, generator=g, device="cuda")
        ln["b"] = 0.1 * torch.randn(ln["b"].shape, generator=g, device="cuda")
    fw = ts.pack_fused_weights(params, cfg, torch.bfloat16)
    check(ts.is_int8(fw) == int8, "tts step: packed weights in the wrong mode")
    name = "tts_decode_step_int8" if int8 else "tts_decode_step"
    B, T, S = 8, 512, 96
    Lyr, H, Dh = cfg.decoder_layers, cfg.decoder_attention_heads, cfg.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    init = [rnd(Lyr, B, H, T, Dh), rnd(Lyr, B, H, T, Dh),
            rnd(Lyr, B, H, S, Dh), rnd(Lyr, B, H, S, Dh)]
    ck = st5.DecoderCache(*(t.clone() for t in init))  # kernel's cache
    cp = st5.DecoderCache(*(t.clone() for t in init))  # plain version's cache
    lens = torch.tensor([96, 1, 50, 96, 17, 80, 96, 33], device="cuda")
    enc_mask = torch.arange(S, device="cuda")[None] < lens[:, None]
    pos0 = torch.tensor([0, 511, 1, 255, 100, 37, 400, 7], device="cuda")
    h_err = h16_err = row_err = 0.0
    h16_ok = True
    written = torch.zeros((B, T), dtype=torch.bool, device="cuda")
    before = (ts.fused_decode_step.launches, ts.fused_decode_step.launches_int8)
    for it in range(4):  # chained: pos advances, caches carry over
        pos = pos0 + it
        # fp32 x, then bf16 x as the engine gives it: h comes back in x's dtype
        x = rnd(B, 1, cfg.hidden_size)
        x = x.float() if it % 2 == 0 else x
        hk = ts._kernel_decode_step(fw, cfg, x, ck, pos, enc_mask)
        hp = ts._plain_decode_step(fw, cfg, x, cp, pos, enc_mask)
        torch.cuda.synchronize()
        check(hk.dtype == x.dtype, f"{name}: hidden in {hk.dtype} for {x.dtype} x")
        err = (hk.float() - hp.float()).abs()
        if x.dtype == torch.float32:
            h_err = max(h_err, err.max().item())
        else:  # a bf16 output is one rounding of the same fp32 value: 2^-7 relative
            h16_err = max(h16_err, err.max().item())
            h16_ok = h16_ok and bool((err <= STEP_TOL + 2 ** -7 * hp.float().abs()).all())
        written[torch.arange(B, device="cuda"), pos.clamp(max=T - 1)] = True
    for a, b in ((ck.self_k, cp.self_k), (ck.self_v, cp.self_v)):
        row_err = max(row_err, (a.float() - b.float()).abs().max().item())
    untouched = all(
        torch.equal(getattr(ck, n).permute(1, 3, 0, 2, 4)[~written],
                    init[i].permute(1, 3, 0, 2, 4)[~written])
        for i, n in enumerate(("self_k", "self_v")))
    untouched = untouched and torch.equal(ck.cross_k, init[2]) \
        and torch.equal(ck.cross_v, init[3])
    moved = (ts.fused_decode_step.launches - before[0],
             ts.fused_decode_step.launches_int8 - before[1])
    check(moved == ((0, 4) if int8 else (4, 0)),
          f"{name}: launch counts moved by {moved} (bf16, int8)")
    check(math.isfinite(h_err) and h_err <= STEP_TOL,
          f"{name} kernel: hidden max abs err {h_err} (fp32 x)")
    check(math.isfinite(h16_err) and h16_ok,
          f"{name} kernel: bf16 hidden max abs err {h16_err} (bf16 x) beyond "
          f"{STEP_TOL} + 2^-7 relative")
    check(math.isfinite(row_err) and row_err <= STEP_TOL,
          f"{name} kernel: cache rows max abs err {row_err}")
    check(untouched, f"{name} kernel: cache rows other than pos changed")

    pos = torch.tensor([256] * B, device="cuda")  # the bound's reference point
    x = rnd(B, 1, cfg.hidden_size)
    step = lambda: ts.fused_decode_step(None, cfg, x, ck, pos, enc_mask, packed=fw)
    # device time (50 steps replayed from one CUDA graph); eager_ms is the
    # same call made from Python back to back, host-bound if the host is slower
    ms = graph_ms(step, 50)
    eager_ms = cuda_ms(step, 50)
    plain_ms = cuda_ms(lambda: ts._plain_decode_step(fw, cfg, x, cp, pos, enc_mask), 10)
    # operations at the bf16 tensor-core rate in both modes (the int8 codes
    # meet fp32 activations); either way the bytes set the bound
    n_bytes = step_bytes(fw, ck, pos, B)
    bms, by = bound_ms(n_bytes, step_ops(fw, ck, pos, B))
    extra = {"bf16_ms_per_step": bf16_ms} if int8 else {}
    emit("kernel_tts_step_int8" if int8 else "kernel_tts_step", tol=STEP_TOL,
         hidden_max_abs_err=h_err, bf16_hidden_max_abs_err=h16_err,
         bf16_tol=f"{STEP_TOL} + 2^-7 relative",
         cache_rows_max_abs_err=row_err, other_rows_untouched=untouched,
         ms_per_step=ms, eager_ms_per_step=eager_ms, plain_ms_per_step=plain_ms,
         launches_per_step=ts.LAUNCHES_PER_STEP,
         step_bytes=n_bytes,
         weight_bytes=sum(t.numel() * t.element_size() for t in fw.values()),
         bound_us=bms * 1e3, bound_by=by, B=B, T=T, S=S, pos=256, **extra)
    return {"name": name, "route": "cuda",
            "source": "infernos_tpu_torch/csrc/tts_step.cu",
            "replaces": "infernos_tpu/ops/tts_step.py:727"
                        + (" (int8w mode, :128)" if int8 else ""),
            "max_abs_err": max(h_err, row_err), "bf16_hidden_max_abs_err": h16_err,
            "ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}, step


# -- phase 5: STT engine at whisper-large-v3 width ----------------------------

def synth_audio(rng, seconds: float, sr: int = 16000) -> np.ndarray:
    """Voiced-like test signal: harmonic tones under a syllable envelope."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(90, 220)
    sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) / h
              for h in range(1, 8))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    sig = sig * env + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def phase_stt(torch, attn, profile_dir=None):
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.serving import stt_engine as stt

    cfg = wsp.WhisperConfig()  # whisper-large-v3 dims
    g = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    params = wsp.init_params(cfg, g, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # random weights never emit EOS: cap the decode (model_actors.py does too)
    ecfg = stt.STTEngineConfig(dtype=torch.bfloat16, max_new_tokens=16)
    eng = stt.STTEngine(params, cfg, ecfg)  # default device: the card
    check(eng.device.type == "cuda", "stt engine is not on the card")
    rng = np.random.default_rng(0)
    audios = [synth_audio(rng, s) for s in (2.0, 3.5, 5.25, 8.0)]

    # the encoder with the kernel vs with the plain version, one request
    n = eng._bucket_for(len(audios[0])) * ecfg.sample_rate
    wav = np.zeros((1, n), np.float32)
    wav[0, :len(audios[0])] = audios[0]
    eng._encode_bucket(wav, n)  # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_k = eng._encode_bucket(wav, n)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    enc_repeat = []  # the same encode five times more: host clocks spread
    for _ in range(5):
        t0 = time.perf_counter()
        eng._encode_bucket(wav, n)
        torch.cuda.synchronize()
        enc_repeat.append((time.perf_counter() - t0) * 1e3)
    plain = lambda q, k, v, *, n_heads, mask=None: attn.by_heads(
        attn._plain_attention, q, k, v, n_heads=n_heads, mask=mask)
    with mock.patch.object(wsp, "fused_attention", plain):
        t0 = time.perf_counter()
        enc_p = eng._encode_bucket(wav, n)
        torch.cuda.synchronize()
        enc_plain_ms = (time.perf_counter() - t0) * 1e3
    ek, ep = enc_k.float(), enc_p.float()
    rel = ((ek - ep).norm() / ep.norm()).item()
    check(bool(torch.isfinite(ek).all()), "stt encoder output not finite")
    check(rel <= ENC_REL_TOL, f"stt encoder kernel vs plain: rel err {rel}")

    t0 = time.perf_counter()
    eng.warmup()  # every bucket once, as a serving actor does at start
    warmup_s = time.perf_counter() - t0
    eng.encode_ms.clear()

    results = {}
    attn.fused_attention.launches = 0  # the main path starts here
    with profile_window(profile_dir) as prof:
        t0 = time.perf_counter()
        for i, a in enumerate(audios):
            eng.submit(stt.STTRequest(
                audio=a, text_cb=lambda r, i=i: results.__setitem__(i, r)))
        steps = 0
        while len(results) < len(audios) and steps < 200:
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = attn.fused_attention.launches  # read right after the main path
    check(len(results) == len(audios), f"stt: {len(results)} of {len(audios)} results")
    check(any(r.tokens for r in results.values()), "stt: no request got a token")
    for i, r in results.items():
        check(len(r.tokens) <= ecfg.max_new_tokens,
              f"stt request {i}: {len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens), f"stt request {i}: bad ids")
        check(math.isfinite(r.no_speech_prob), f"stt request {i}: ns prob not finite")
    check(launches == cfg.encoder_layers * len(audios),
          f"stt: attention kernel launched {launches} times, want "
          f"{cfg.encoder_layers} per encode")
    emit("stt", model="whisper-large-v3", init_s=init_s, warmup_s=warmup_s,
         steps=steps, wall_s=wall_s,
         attention_launches=launches, encode_ms=eng.encode_ms,
         encode_ms_warm=enc_ms, encode_ms_plain_attention=enc_plain_ms,
         encode_ms_warm_repeat=enc_repeat,
         encoder_rel_err=rel, encoder_rel_tol=ENC_REL_TOL,
         latency_s=[results[i].inf_time for i in range(len(audios))],
         audio_s=[len(a) / 16000 for a in audios],
         n_tokens=[len(results[i].tokens) for i in range(len(audios))],
         **profile_summary(torch, prof, wall_s, profile_dir, "stt"))
    return launches, params


# -- phase 6: TTS engine at SpeechT5 + HiFi-GAN + AmendNet width ---------------

def tick_mel_rel_err(torch, eng, tts, ts, st5, sessions) -> float:
    """One tick's mel chunk (before the vocoder) decoded with the step
    kernel and, from the same state and dropout draws, with the plain step;
    returns their relative L2 error.  The sessions first run two ticks, so
    every slot is past pos 0; they are cancelled and drained afterwards."""
    import dataclasses

    sids = [eng.start_session(*s, lambda a: None) for s in sessions]
    for _ in range(2):
        eng.step()

    def clone(st):
        kw = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
        c = kw.pop("cache")
        return tts.TTSState(cache=st5.DecoderCache(*(
            getattr(c, f.name).clone() for f in dataclasses.fields(c))),
            **{k: v.clone() for k, v in kw.items()})

    def plain(params, cfg, x, cache, pos, enc_mask=None, *, packed):
        return ts._plain_decode_step(packed, cfg, x, cache, pos, enc_mask)

    paused = torch.zeros(eng.ecfg.batch_slots, dtype=torch.bool, device="cuda")
    n_frames = max(eng.ecfg.chunk_schedule)
    with eng._lock:
        snap, gen = clone(eng.state), eng._gen.get_state()
        mel_k, _ = eng._decode_chunk(paused, n_frames)
        after = eng.state
        eng.state = snap
        eng._gen.set_state(gen)
        with mock.patch.object(tts, "fused_decode_step", plain):
            mel_p, _ = eng._decode_chunk(paused, n_frames)
        eng.state = after
    for sid in sids:
        eng.cancel_session(sid)
    while eng.step():
        pass
    mk, mp = mel_k.float(), mel_p.float()
    check(bool(torch.isfinite(mk).all()), "tts mel chunk not finite")
    return ((mk - mp).norm() / mp.norm()).item()


def phase_tts(torch, ts, profile_dir=None):
    from infernos_tpu_torch.models import amendnet as amd
    from infernos_tpu_torch.models import hifigan as hfg
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.models.tokenizers import CharTokenizer
    from infernos_tpu_torch.serving import tts_engine as tts
    from infernos_tpu_torch.serving.speakers import SpeakerBank

    cfg, vcfg = st5.SpeechT5Config(), hfg.HifiGanConfig()
    g = torch.Generator(device="cuda").manual_seed(6)
    params = st5.init_params(cfg, g, "cuda", torch.bfloat16)
    vparams = hfg.init_params(vcfg, g, "cuda", torch.bfloat16)
    aparams = amd.load_pretrained("cuda", torch.bfloat16)
    check(aparams is not None, "vendored AmendNet weights missing")
    # random weights never fire the stop token (model_actors.py sets 2.0 too)
    ecfg = tts.TTSEngineConfig(dtype=torch.bfloat16, stop_threshold=2.0)
    eng = tts.TTSEngine(params, cfg, vparams, vcfg, ecfg, amd_params=aparams)
    tok, bank = CharTokenizer(), SpeakerBank.synthetic(dim=cfg.speaker_embedding_dim)
    texts = ["hello, how can i help you today?",
             "the meeting moved to three thirty.",
             "please hold while i transfer your call.",
             "thank you for calling, goodbye!"]
    t0 = time.monotonic()
    eng.warmup()  # every join size and chunk size once, as an actor does
    warmup_s = time.monotonic() - t0
    mel_rel = tick_mel_rel_err(torch, eng, tts, ts, st5, [
        (tok(t), bank.get(i)) for i, t in enumerate(texts)])
    check(math.isfinite(mel_rel) and mel_rel <= MEL_REL_TOL,
          f"tts mel chunk kernel vs plain: rel err {mel_rel}")
    eng.tick_ms.clear()
    eng._last_dispatch_t = None
    chunks = {i: [] for i in range(len(texts))}
    sr, fs = ecfg.sample_rate, vcfg.total_upsample

    def samples(i):
        return sum(len(c) for c in chunks[i] if c is not None)

    first = {}
    ts.fused_decode_step.launches = 0  # the main path starts here
    ts.fused_decode_step.launches_int8 = 0
    with profile_window(profile_dir) as prof:
        t0 = time.monotonic()
        sids = [eng.start_session(tok(t), bank.get(i), chunks[i].append)
                for i, t in enumerate(texts)]
        ticks = 0
        while min(samples(i) for i in chunks) < sr and ticks < 64:
            eng.step()
            ticks += 1
            for i in chunks:
                if i not in first and samples(i) > 0:
                    first[i] = time.monotonic() - t0
        for sid in sids:
            eng.cancel_session(sid)
        while eng.step() and ticks < 128:
            ticks += 1
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    launches = ts.fused_decode_step.launches  # read right after the main path
    check(launches > 0, "tts: the decoder-step kernel never launched")
    rms = []
    for i, cs in chunks.items():
        audio = [c for c in cs if c is not None]
        check(cs and cs[-1] is None, f"tts session {i}: no end of stream")
        check(samples(i) >= sr, f"tts session {i}: {samples(i)} samples < 1 s")
        for c in audio:
            check(len(c) % fs == 0, f"tts session {i}: chunk of {len(c)} samples "
                  f"is not whole {fs}-sample mel frames")
            check(bool(np.isfinite(c).all()), f"tts session {i}: NaN/Inf audio")
        stream = np.concatenate(audio)
        pkts = stream[: len(stream) // 320 * 320].reshape(-1, 320)  # 20 ms RTP frames
        check(len(pkts) >= 50, f"tts session {i}: {len(pkts)} 20 ms packets")
        rms.append(float(np.sqrt(np.mean(stream.astype(np.float64) ** 2))))
        # liveness only: random weights give audio far below full scale;
        # the mel chunk comparison above is the check of the values
        check(rms[-1] > 0.0, f"tts session {i}: silent audio")
    emit("tts", model="speecht5+hifigan+amendnet", warmup_s=warmup_s,
         ticks=ticks, wall_s=wall_s,
         step_launches=launches, launches_per_step=ts.LAUNCHES_PER_STEP,
         mel_chunk_rel_err=mel_rel, mel_rel_tol=MEL_REL_TOL,
         first_chunk_s=[first[i] for i in sorted(first)],
         ms_per_tick=eng.tick_ms, samples=[samples(i) for i in chunks], rms=rms,
         **profile_summary(torch, prof, wall_s, profile_dir, "tts"))
    return launches


# -- phase 7: one translated turn per channel, G.711 in to G.711 out -----------

FRAME_BYTES = 160  # 20 ms of G.711 at 8 kHz
FIXED_SENTENCE = "the line is open, please go ahead."


class _Leg:
    """One channel of the turn phase: its sessions, what it heard and said,
    and its outgoing G.711 stream cut into 20 ms frames."""

    def __init__(self, idx):
        self.idx = idx
        self.segments = []   # (ipos, n_samples) of each VAD segment
        self.results = []    # STTResult of each engine request
        self.said = []       # sentence groups handed to the TTS session
        self.fixed = 0       # results that held no speakable character
        self.say_t0 = {}     # say number -> time of say()
        self.first_s = []    # first-chunk latency of each say
        self.markers = 0     # end-of-say markers seen in the out stream
        self.says_done = 0   # done callbacks of whole say requests
        self.frames = []     # outgoing 160-byte frames
        self._tail = b""
        self._await_first = None
        self.lock = threading.Lock()


def phase_turn(torch, attn, ts, stt_params):
    """Build the turn's engines at full width on the card, drive the turn,
    print its line; returns the launch counts of its run (attention, int8
    step kernel, bf16 step kernel)."""
    from infernos_tpu_torch.models import amendnet as amd
    from infernos_tpu_torch.models import hifigan as hfg
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.models import vad
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.models.quant import quantize_params, quantized_bytes
    from infernos_tpu_torch.serving import stt_engine as stt
    from infernos_tpu_torch.serving import tts_engine as tts
    from infernos_tpu_torch.serving.stt_tiered import TieredSTTConfig, TieredSTTEngine

    wcfg = wsp.WhisperConfig()
    t0 = time.perf_counter()
    # random weights never emit EOS: cap the decode (as the stt phase does)
    tcfg = TieredSTTConfig(dtype=torch.bfloat16, base=stt.STTEngineConfig(
        dtype=torch.bfloat16, max_new_tokens=16))
    stt_eng = TieredSTTEngine(stt_params, wcfg, tcfg)  # default tier slots
    check(stt_eng.device.type == "cuda", "tiered stt engine is not on the card")
    check(stt_eng.short.params is stt_eng.long.params,
          "tiered stt: the tiers do not share one parameter tree")
    stt_eng.warmup()
    for e in (stt_eng.short, stt_eng.long):
        e.encode_ms.clear()
    stt_warm_s = time.perf_counter() - t0

    cfg, vcfg = st5.SpeechT5Config(), hfg.HifiGanConfig()
    g = torch.Generator(device="cuda").manual_seed(7)
    dense = st5.init_params(cfg, g, "cuda", torch.bfloat16)
    dense_bytes = quantized_bytes(dense)
    params = quantize_params(dense)  # int8 codes + fp32 scales, after the cast
    del dense
    vparams = hfg.init_params(vcfg, g, "cuda", torch.bfloat16)
    aparams = amd.load_pretrained("cuda", torch.bfloat16)
    check(aparams is not None, "vendored AmendNet weights missing")
    # random weights never fire the stop token; the per-say output gain is
    # on, as a deployment on untrained weights sets it (it locks on the
    # first chunk above 1e-7 rms)
    ecfg = tts.TTSEngineConfig(dtype=torch.bfloat16, stop_threshold=2.0,
                               async_harvest=True, output_norm_rms=0.05)
    t0 = time.perf_counter()
    tts_eng = tts.TTSEngine(params, cfg, vparams, vcfg, ecfg, amd_params=aparams)
    check(ts.is_int8(tts_eng.packed), "tts engine did not pack int8 weights")
    check(tts_eng.packed["sqkv"].dtype == torch.float32, "int8 scales not fp32")
    tts_eng.warmup()
    tts_warm_s = time.perf_counter() - t0
    tts_eng.tick_ms.clear()
    tts_eng.tick_frames.clear()
    tts_eng._last_dispatch_t = None

    vparams_vad = vad.load_pretrained("cuda")
    check(vparams_vad is not None, "vendored VAD weights missing")
    out = drive_turn(torch, attn, ts, stt_eng, tts_eng, vparams_vad,
                     vad.VADConfig())
    from infernos_tpu_torch.utils.platform import card_info

    emit("turn", card=card_info(), stt_warmup_s=stt_warm_s, tts_warmup_s=tts_warm_s,
         tts_param_bytes={"bf16": dense_bytes, "int8": quantized_bytes(params)},
         **out)
    return (out["attention_launches"], out["int8_step_launches"],
            out["bf16_step_launches"])


def drive_turn(torch, attn, ts, stt_eng, tts_eng, vparams_vad, vcfg_vad,
               n_legs=4):
    """Four channels of mu-law payloads through VAD, STT sessions, T2T and TTS
    sessions of the given engines, to 160-byte frames; checks the turn and
    returns its numbers.  The kernels' launch counts are set to 0 right
    before the first payload and read right after the last say is done."""
    from infernos_tpu_torch.audio.chunk import AudioChunk
    from infernos_tpu_torch.audio.codecs.g711 import G711Codec
    from infernos_tpu_torch.audio.markers import ASMarkerNewSent, ASMarkerSentDoneCB
    from infernos_tpu_torch.models import vad
    from infernos_tpu_torch.models.tokenizers import CharTokenizer
    from infernos_tpu_torch.serving import sessions as ses
    from infernos_tpu_torch.serving.driver import EngineDriver
    from infernos_tpu_torch.serving.speakers import SpeakerBank
    from infernos_tpu_torch.serving.vad_engine import VADChannel, VADWorker
    from infernos_tpu_torch.t2t import (NumbersToWords, Translator,
                                        regroup_sentences, sent_split)
    from infernos_tpu_torch.t2t.lexicon import LexiconBackend

    sr_in = 8000
    cfg, ecfg = tts_eng.cfg, tts_eng.ecfg
    enc_layers = stt_eng.short.cfg.encoder_layers
    max_tokens = stt_eng.ecfg.max_new_tokens
    models = []

    def vad_factory(n):
        models.append(vad.NeuralVAD(vparams_vad, vcfg_vad, n))  # on the card
        return models[-1]

    worker = VADWorker(vad_factory, window=vcfg_vad.window)
    stt_drv = EngineDriver(stt_eng, name="stt")
    tts_drv = EngineDriver(tts_eng, name="tts")

    # -- the four legs ---------------------------------------------------------
    codec = G711Codec()
    tok = CharTokenizer()
    bank = SpeakerBank.synthetic(dim=cfg.speaker_embedding_dim)
    translator = Translator("en", "pt", backend=LexiconBackend())
    n2w = NumbersToWords("pt")
    speakable = set(tok.char_to_id) - set(" '.,?!-")
    legs = [_Leg(i) for i in range(n_legs)]
    errors = []

    def guard(fn):  # a failure on a worker thread fails the phase
        def run(*a, **kw):
            try:
                return fn(*a, **kw)
            except Exception as e:  # noqa: BLE001 - re-raised by the phase
                errors.append(e)
                raise
        return run

    def wire(leg):
        stt_sess = ses.STTSession(stt_eng)
        tts_sess = ses.TTSSession(tts_eng, tok, bank)

        @guard
        def soundout(item):
            with leg.lock:
                if isinstance(item, AudioChunk):
                    if leg._await_first is not None:
                        leg.first_s.append(time.monotonic() - leg._await_first)
                        leg._await_first = None
                    check(item.samplerate == ecfg.sample_rate, "tts chunk rate")
                    pcm = item.resample(sr_in).audio
                    check(bool(np.isfinite(pcm).all()), "NaN/Inf in the out stream")
                    leg._tail += codec.encode(pcm)
                elif isinstance(item, ASMarkerNewSent):
                    leg.markers += 1
                    pad = -len(leg._tail) % FRAME_BYTES  # whole frames per say
                    leg._tail += codec.silence(pad)
                while len(leg._tail) >= FRAME_BYTES:
                    leg.frames.append(leg._tail[:FRAME_BYTES])
                    leg._tail = leg._tail[FRAME_BYTES:]
            if isinstance(item, ASMarkerSentDoneCB):
                item.on_proc()  # what the pacer does when the stream drains to it

        @guard
        def say_done():
            with leg.lock:
                leg.says_done += 1
                leg._await_first = None

        @guard
        def text_in(res):
            text = res.text.strip()
            translated = translator.translate(text)
            groups = regroup_sentences(sent_split(n2w(translated)))
            if not any(c in speakable for grp in groups for c in grp.lower()):
                groups = [FIXED_SENTENCE]  # a choice of input, not a fallback
                leg.fixed += 1
                print(f"turn: leg {leg.idx} result {text!r} holds no speakable "
                      f"character; saying the fixed sentence", flush=True)
            with leg.lock:
                leg.results.append(res)
                leg.said.append(groups)
                leg._await_first = time.monotonic()
            tts_sess.say(ses.TTSRequest(groups, speaker_id=leg.idx,
                                        done_cb=say_done))
            tts_drv.kick()

        @guard
        def vad_chunk_in(chunk):
            with leg.lock:
                leg.segments.append((chunk.ipos, len(chunk.audio)))
            stt_sess.soundin(ses.STTRequest(chunk=chunk, text_cb=text_in))
            stt_drv.kick()

        tts_sess.start(soundout)
        return VADChannel(lambda c, active: None, vad_chunk_in, codec,
                          sample_rate=sr_in, window=vcfg_vad.window)

    chans = [wire(leg) for leg in legs]
    rng = np.random.default_rng(7)

    def quiet(seconds):
        return (0.001 * rng.standard_normal(int(sr_in * seconds))).astype(np.float32)

    payloads = []
    for i in range(n_legs):  # two utterances per leg, pauses between
        wav = np.concatenate([quiet(0.5), synth_audio(rng, 1.5 + 0.5 * i, sr_in),
                              quiet(1.5), synth_audio(rng, 1.0, sr_in), quiet(1.0)])
        payloads.append(codec.encode(wav))
    n_in = max(len(p) for p in payloads) // FRAME_BYTES

    # -- drive it: the counts start here ---------------------------------------
    worker.start()
    stt_drv.start()
    tts_drv.start()
    attn.fused_attention.launches = 0
    ts.fused_decode_step.launches = 0
    ts.fused_decode_step.launches_int8 = 0
    try:
        t0 = time.monotonic()
        for k in range(n_in):  # 20 ms payloads at the pace of a call
            for ch, pay in zip(chans, payloads):
                frame = pay[k * FRAME_BYTES:(k + 1) * FRAME_BYTES]
                if len(frame) == FRAME_BYTES:
                    ch.ingest(worker, frame)
            lag = t0 + (k + 1) * 0.020 - time.monotonic()
            if lag > 0:
                time.sleep(lag)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not errors:
            with_all = all(len(l.segments) >= 2 and len(l.results) == len(l.segments)
                           and l.says_done == len(l.results) for l in legs)
            if with_all and stt_eng.n_active == 0 and tts_eng.n_active == 0:
                break
            time.sleep(0.05)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    finally:
        worker.stop()
        stt_drv.stop()
        tts_drv.stop()
        tts_eng.close()
    attn_launches = attn.fused_attention.launches
    bf16_steps = ts.fused_decode_step.launches
    int8_steps = ts.fused_decode_step.launches_int8
    if errors:
        raise errors[0]
    for t in (worker, stt_drv, tts_drv, *([tts_eng._hthread] if ecfg.async_harvest else [])):
        check(not t.is_alive(), f"turn: thread {t.name} did not stop")

    # -- checks ------------------------------------------------------------------
    encodes = len(stt_eng.short.encode_ms) + len(stt_eng.long.encode_ms)
    n_results = sum(len(l.results) for l in legs)
    steps_run = sum(n // cfg.reduction_factor for n in tts_eng.tick_frames)
    for l in legs:
        check(len(l.segments) >= 1, f"turn leg {l.idx}: no VAD segment")
        check(len(l.results) == len(l.segments),
              f"turn leg {l.idx}: {len(l.results)} STT results for "
              f"{len(l.segments)} segments")
        for r in l.results:
            check(0 < len(r.tokens) <= max_tokens,
                  f"turn leg {l.idx}: {len(r.tokens)} tokens")
        n_groups = sum(len(grp) for grp in l.said)
        check(l.says_done == len(l.results),
              f"turn leg {l.idx}: {l.says_done} says done of {len(l.results)}")
        check(l.markers == n_groups,
              f"turn leg {l.idx}: {l.markers} end markers for {n_groups} sentences")
        check(len(l._tail) == 0 and all(len(f) == FRAME_BYTES for f in l.frames),
              f"turn leg {l.idx}: out stream is not whole {FRAME_BYTES}-byte frames")
        check(len(l.frames) >= 50 * n_groups,
              f"turn leg {l.idx}: only {len(l.frames)} frames out")
    check(n_results == encodes, f"turn: {n_results} results from {encodes} encodes")
    check(attn_launches == enc_layers * encodes,
          f"turn: attention kernel launched {attn_launches} times for "
          f"{encodes} encodes, want {enc_layers} each")
    check(int8_steps == steps_run and int8_steps > 0,
          f"turn: int8 step kernel launched {int8_steps} times for {steps_run} steps")
    check(bf16_steps == 0, f"turn: the bf16 step kernel launched {bf16_steps} times")

    # VAD ms per batched forward: the four legs' windows in one call
    win = np.stack([codec.decode(p[:vcfg_vad.window]) for p in payloads])
    slots = np.arange(n_legs)
    vad_model = models[0]
    for _ in range(3):
        vad_model(win, slots=slots)
    t0 = time.perf_counter()
    for _ in range(20):
        vad_model(win, slots=slots)
    vad_ms = (time.perf_counter() - t0) / 20 * 1e3
    return dict(legs=n_legs, wall_s=wall_s,
         segments=[l.segments for l in legs],
         n_tokens=[[len(r.tokens) for r in l.results] for l in legs],
         stt_latency_s=[[r.inf_time for r in l.results] for l in legs],
         stt_tier_encodes={"short": len(stt_eng.short.encode_ms),
                           "long": len(stt_eng.long.encode_ms)},
         said=[l.said for l in legs], fixed_sentences=sum(l.fixed for l in legs),
         tts_first_chunk_s=[l.first_s for l in legs],
         tts_ms_per_tick_int8=tts_eng.tick_ms,
         tts_tick_frames=tts_eng.tick_frames,
         frames_out=[len(l.frames) for l in legs],
         # information only: a say whose chunks all stay under the gain
         # lock's 1e-7 rms threshold passes through unscaled, as silence
         frames_not_silence=[sum(f != codec.silence(FRAME_BYTES) for f in l.frames)
                             for l in legs],
         attention_launches=attn_launches, int8_step_launches=int8_steps,
         bf16_step_launches=bf16_steps,
         vad_ms_per_forward=vad_ms, vad_batch=n_legs, tts_steps_run=steps_run)


# -- last phase: what the card runs for one attention call and one encode -----

def device_launches(torch, fn) -> int:
    """How many kernels and copies the card runs for one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_device_launches(torch, attn, step_calls=None, stt_params=None):
    """Counts, with the profiler, the kernels and copies of one
    ``fused_attention`` call at the encoder's shape (want 1: the kernel),
    of the same kernel behind a head split, of one ``fused_decode_step``
    call at full width in each weight mode (``step_calls``: the step
    phases' own calls; want 1 each), and of one ``whisper.encode``.
    It runs last: once the profiler has been on, every later launch of the
    process costs the host more, which would spoil the phases' host clocks."""
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn((1, 1500, 1280), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = {"fused_attention": device_launches(
               torch, lambda: attn.fused_attention(q, k, v, n_heads=20)),
           "split_heads": device_launches(
               torch, lambda: attn.by_heads(attn._kernel_attention, q, k, v,
                                            n_heads=20))}
    for mode, fn in (step_calls or {}).items():
        out[f"fused_decode_step_{mode}"] = device_launches(torch, fn)
    if stt_params is not None:
        from infernos_tpu_torch.models import whisper as wsp

        cfg = wsp.WhisperConfig()
        mel = torch.randn((1, cfg.num_mel_bins, 3000), generator=g,
                          device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            out["whisper_encode"] = device_launches(
                torch, lambda: wsp.encode(stt_params, cfg, mel))
        out["encoder_layers"] = cfg.encoder_layers
    emit("device_launches", **out)
    check(out["fused_attention"] == 1,
          f"fused_attention ran {out['fused_attention']} kernels and copies "
          f"on the card, want the attention kernel alone")
    for mode in step_calls or {}:
        n = out[f"fused_decode_step_{mode}"]
        check(n == 1, f"fused_decode_step ({mode}) ran {n} kernels and copies "
                      f"on the card, want the step kernel alone")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile the engine runs; kernel tables go to DIR")
    ap.add_argument("--only", choices=["attention", "kernels"],
                    help="stop after the attention kernel's phase, or after "
                         "all kernel phases (prints no result line)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.ops import attention as attn
    from infernos_tpu_torch.ops import build
    from infernos_tpu_torch.ops import tts_step as ts
    from infernos_tpu_torch.utils.platform import card_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    check(card is not None, "nvidia-smi did not report the card")
    print(card, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), card=card, torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
    t0 = time.perf_counter()
    build.build(verbose=True)
    sass = sass_summary(build, "attention")
    step_sass = sass_summary(build, "tts_step")
    emit("build", seconds=time.perf_counter() - t0, sources=list(build.SOURCES),
         attention_sass=sass, tts_step_sass=step_sass)
    check(sass is None or sass["HGMMA"] > 0,
          "the attention library holds no warpgroup product (HGMMA)")
    check(step_sass is None or step_sass["HMMA"] > 0,
          "the decoder-step library holds no tensor-core product (HMMA)")

    kernels = [phase_attention(torch, attn)]
    if args.only == "attention":
        phase_device_launches(torch, attn)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0
    row, bf16_step = phase_tts_step(torch, st5, ts)
    kernels.append(row)
    row, int8_step = phase_tts_step(torch, st5, ts, int8=True, bf16_ms=row["ms"])
    kernels.append(row)
    step_calls = {"bf16": bf16_step, "int8": int8_step}
    if args.only == "kernels":
        phase_device_launches(torch, attn, step_calls)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0
    stt_launches, stt_params = phase_stt(torch, attn, args.profile)
    tts_launches = phase_tts(torch, ts, args.profile)
    check(ts.fused_decode_step.launches_int8 == 0,
          "tts: a dense tree went through the int8 step kernel")
    turn_attn, turn_int8, turn_bf16 = phase_turn(torch, attn, ts, stt_params)
    phase_device_launches(torch, attn, step_calls, stt_params)
    # each path was driven with the counts at 0 before it and read after it
    kernels[0]["launches"] = stt_launches + turn_attn
    kernels[0]["launches_by_path"] = {"stt": stt_launches, "turn": turn_attn}
    kernels[1]["launches"] = tts_launches + turn_bf16
    kernels[1]["launches_by_path"] = {"tts": tts_launches, "turn": turn_bf16}
    kernels[2]["launches"] = turn_int8
    kernels[2]["launches_by_path"] = {"turn": turn_int8}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
