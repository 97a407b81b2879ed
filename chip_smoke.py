#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``infernos_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line:

1. device   -- card name and power limit, TF32 off for the references;
2. build    -- nvcc builds ``infernos_tpu_torch/csrc/*.cu`` (one process
               per source, in parallel);
3. kernel 1 -- encoder attention kernel vs its plain PyTorch version, at
               whisper-large-v3's shapes and at the tiny-real encoder's,
               in bf16 and then (``kernel_attention_fp32``) in its fp32
               mode, each fp32 shape timed beside
               ``scaled_dot_product_attention`` on the same fp32 inputs;
4. kernel 2 -- SpeechT5 decoder-step kernel vs its plain version in its
               four modes: bf16 weights, int8 weights with
               per-output-channel scales (``kernel_tts_step_int8``), both
               over bf16 caches through the grid kernel (one cooperative
               launch per step of up to 32 slots), and each over fp32
               caches through the cluster kernel (one launch per step, a
               thread-block cluster per 8 slots;
               ``kernel_tts_step_fp32``, ``kernel_tts_step_int8_fp32``);
               each mode at full width, at the tiny-real TTS engine's
               shapes on its weights (the fp32-cache modes also timed
               there), and at 40 and 48 slots (``wide``); then a
               tiny-real ``TTSEngine`` of 40 slots runs 6 ticks with 40
               sessions (``tts_wide_engine``, fp32 caches);
   cross_i8 -- the int8-direct cross-attention kernel
               (``kernel_cross_i8``, ``csrc/cross_attention_i8.cu``, the
               port of the reference's XLA path
               ``layers.cross_attention_step_i8``) vs its plain version on
               the same tensors at S 1, 63 and 1500 and B * H of 1 and 320,
               unmasked and with per-slot lengths (some slots empty), in
               bf16 (and fp32 at the main shape); timed at ``[16, 20, 1500,
               64]`` beside the dequantize path it replaces;
5. stt      -- the STT engine at whisper-large-v3 width serves 4 requests;
               then (``stt_cross_i8``) the same params in an engine with
               ``cross_int8_direct=True`` serve them again: 32 launches of
               the cross kernel per decode step; on the cache it left, one
               step's logits within a bound of the dequantize path's, each
               layer's kernel call held to the plain version;
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
8. rtp_call -- a two-leg call over real UDP on 127.0.0.1 with the trained
               tiny-real pair from the port's loaders (fp32 on the card,
               Griffin-Lim vocoder): two far ends stream rendered speech as
               G.711 RTP at 20 ms pace into two RTPEndpoints on one
               RTPIngest (jitter buffer, NeuralVAD) -> STTSession -> T2T ->
               TTSSession (dense TTSEngine) -> the other endpoint's native
               pacer -> RTP back; what each far end hears is transcribed and
               must reach 0.6 word accuracy in both directions; it also
               prints the native pacer's jitter share at 500 legs;
9. sip_call -- the same bilingual call through the daemon's own layers, in
               process: the YAML config read by ``InfernConfig``,
               ``build_cluster`` (RTP, LiveTranslator and SIP actors; STT and
               two TTS model actors on tiny-real, fp32), a ``FakePhone``
               calling the SIP port and a ``FarEnd`` the app dials; both
               directions must reach 0.6 word accuracy; then both TTS
               engines say at once (one stream, one step scratch), and each
               say must equal the same say made alone from the same
               generator state; Bob must get the BYE and no actor thread
               may be left;
10. remote_call -- the same call with its STT in a second process on the
               card: a peer serving the port's ``cluster.remote.ActorServer``
               on 127.0.0.1 hosts a Whisper-large-v3 ``STTActor`` (stt_ladder's
               draw), whose tokens for the ``stt`` phase's four utterances,
               each ``text_cb`` crossing back over the socket, must equal the
               same actor's in this process; then a tiny-real ``STTActor`` in
               the peer serves the bilingual call as ``build_cluster``'s
               ``stt_actr`` (0.6 word accuracy both ways; kernel 1 counted in
               the peer); then the peer gets SIGKILL with an ask outstanding,
               which must fail with ``ConnectionError`` at once;
11. daemon  -- ``python -m infernos_tpu_torch -f cfg.yaml`` in a subprocess
               at full width (Whisper-large-v3 tiered, two SpeechT5 +
               HiFi-GAN + AmendNet engines, bf16, zero weights): two
               concurrent calls bridged to a ``FarEnd``, paced RTP to every
               far end, STT and TTS work on ``/metrics``, no driver crash,
               exit 0 within 30 s of SIGTERM;
12. llm     -- the LLM engine as the full ``LLMActor`` starts it
               (Qwen2.5-7B dims, zeros made in the int8 layout on the card,
               random embedding and readout, bf16) serving four chat
               requests of 64 tokens, one per prompt bucket and one short: each
               request's tokens in the batch equal a run of it alone, the
               peak memory stays under the dense bf16 weights; prefill and
               decode times beside the decode step's bound;
13. llm_tiny -- the trained tiny LLM in fp32: its replies to fixed
               attendant contexts must be the training policy's;
14. aia_call -- the AI attendant through SIP and the actors, in process,
               on the tiny-real trio (fp32, Griffin-Lim): a ``FakePhone``
               says "hello" (greeted) and "transfer me to billing please"
               (transferred); the LLM's replies must be the policy's and
               her packets must carry the audio the TTS emitted;
15. daemon_aia -- the daemon with an ``ai_attendant`` profile at full
               width (Whisper-large-v3 tiered, Qwen2.5-7B int8, SpeechT5 +
               HiFi-GAN + AmendNet, zero weights): one call of one
               utterance, STT, LLM and TTS work on ``/metrics``, paced RTP
               holding the emitted audio, exit 0 within 30 s of SIGTERM;
16. paced_tts -- ``python -m infernos_tpu_torch.bench.ttsmain`` (full-width
               SpeechT5 + HiFi-GAN, zero weights, bf16, 24 slots) ramping
               paced calls over 4 s levels: every level spoke, one step
               kernel launch per step; prints the paced calls and ticks;
17. lt_bench_tiny -- ``python -m infernos_tpu_torch.bench.ltbench
               --tiny-real --calls 4 --turns 2``: four two-leg calls of real
               speech through SIP, VAD, the tiny STT, T2T and the tiny TTS;
               4 answered, 8 turns measured, none failed;
18. lt_ramp -- ``python -m infernos_tpu_torch.bench.ltbench --ramp --full
               --turns 1`` at full width on the ladder 1, 2 calls:
               the north star's ``lt_calls_per_chip``, each level's turn
               latency, the engines' stage metrics;
19. loopback -- ``python -m infernos_tpu_torch.bench.loopback --speakers 4
               --prompts 2``: tiny-real TTS into tiny-real STT, mean
               similarity at least the reference's on the CPU less 0.1;
20. stt_ladder -- the STT engine at whisper-large-v3 width with the
               quality ladder on (temperatures 0.5 and 1.0, then a beam of
               5): every request of random weights fails the gate, is
               decoded again at each temperature and once by beam search
               and calls back once; then ``beam_decode`` in fp32: W 1 gives
               a greedy loop's ids, W 5 a sum logprob at least W 1's;
21. sttbench -- ``python -m infernos_tpu_torch.bench.sttbench --full``
               (16 slots, 24 new tokens, 16 G.711 utterances): all come
               back; the realtime factor and latency percentiles;
22. ttsbench -- ``python -m infernos_tpu_torch.bench.ttsbench 16 --full``
               (8 slots, 128 frames): 16 sessions with frames; first frame
               and real-time ratio;
23. ttsprobe -- ``python -m infernos_tpu_torch.bench.ttsprobe --slots 24
               --ticks 60 --frames 96``: the kernel path's tick time;
24. llmbench -- ``python -m infernos_tpu_torch.bench.llmbench --dims 7b``
               with K 8 and with ``--spec``: every request finishes;
               tokens/s and generation latency;
25. parallel -- the parallel plane over rank processes on the card
               (``infernos_tpu_torch/parallel``): ``dryrun_multichip(2)``
               (two ranks over gloo; each rank's TTS and STT engines launch
               kernels 2 and 1, counted in the rank); Qwen2.5-14B at full
               width, 4 of 48 layers, int8, tensor-parallel over 4 ranks
               (gloo), every logits row within 4e-2 (relative L2) of the
               unsharded engine's, and the prefill rows no further from
               fp32 activations on the same int8 tree than 1.25 times the
               unsharded engine's rows are; each rank's
               parameter bytes equal to the budget's;
               the same engine code at tp 1 in a one-rank NCCL group, its
               tokens equal to the unsharded engine's;
26. aia_bench -- ``python -m infernos_tpu_torch.bench.aiabench --tiny-real
               --calls 2 --turns 2``: 2 answered, every turn replied to
               but those the tiny LLM answers with ``<nothingtosay>``;
27. echo    -- ``python -m infernos_tpu_torch.bench.echo --tiny-real
               --utterances 2``: an echo per utterance over RTP, no SIP;
28. ramp_profile -- ``ltbench --ramp --full --turns 1 --levels 2`` with
               ``INFERNOS_PYSAMPLER``: the host profile of a two-call
               level (on-CPU and waiting leaves, threads);
29. ckpt_port -- HF-layout state dicts of Whisper large-v3, SpeechT5 and
               HiFi-GAN built on the card at HF's init, written into a hub
               cache as the published repos store them (Whisper as fp16
               safetensors shards, SpeechT5 as one safetensors file,
               HiFi-GAN as ``pytorch_model.bin``), ported by
               ``python -m infernos_tpu_torch.tools.port_checkpoints --stt
               --tts`` and ``--tts --int8`` in subprocesses, loaded cold
               (every leaf bit for bit against the file's tensor, the int8
               tree equal to ``quantize_params`` of the fp32 one), then
               served by ``STTActor`` (one 5 s utterance, tokens against
               ``whisper.decode_full``), ``TTSActor`` (one say of 64
               steps, each step against ``speecht5.decode_full``, finite
               audio) and a second ``TTSActor`` on the int8 checkpoint
               (kernel 2's int8 mode, against ``decode_full`` of the tree
               dequantized);
30. examples -- ``infernos_tpu_torch.examples.tts_stream --full`` says two
               texts through kernel 2 (a WAV of 96 mel frames each) and
               ``llm_test`` at tiny width runs 4 sessions of 2 rounds (a
               latency each);
31. train   -- the trainers (``infernos_tpu_torch/tools``): the attention
               kernel's autograd Function (the kernel's forward, the
               reference's recomputed backward) against fp32 autograd of the
               plain attention at large-v3 and tiny widths, masked and not,
               in fp32 (and bf16 at large-v3 width); one tiny STT step
               through the kernel against the same step through the plain
               attention (2 fp32 launches a step); then the STT, SpeechT5,
               HiFi-GAN, LLM, VAD and AmendNet trainers 30 steps each on
               two pre-built batches (fp32 throughout, as the reference
               trains), each loss finite and falling, each checkpoint saved
               under ``infernos_tpu_torch/build/trained`` and served once
               through the port's loaders;
32. launches -- the kernels and copies the card runs for one
               ``fused_attention`` call in each dtype (1), one
               ``fused_decode_step`` call in each mode (1), one
               ``cross_attention_i8`` call (1) and one
               ``whisper.encode``, counted with the profiler, last so that
               it slows nothing.

Then the ``{"kernels": [...]}`` line, a row per kernel mode with its
launches by path, and, last, ``{"ok": true, ...}``.  The tiny and
tiny-real engines and the trainers run the kernels' fp32 modes, the
full-width engines the bf16 ones, as the reference does; every path is
held to its modes (a launch of another mode fails it), and only
``stt_cross_i8`` may launch the int8-direct cross kernel.
Weights are random, from fixed seeds, except in ``rtp_call``,
``sip_call``, ``llm_tiny``, ``aia_call``, ``lt_bench_tiny``,
``loopback``, ``aia_bench`` and ``echo``, which serve the vendored trained
tiny models, and ``daemon``, ``daemon_aia``, ``paced_tts``, ``lt_ramp``,
``ttsprobe``, ``llmbench`` and ``ramp_profile``, which start
with zero weights as the actors do without a checkpoint (the LLM's
embedding and readout random, as its actor starts them); ``ckpt_port``
serves HF's init (N(0, 0.02) weights, zero biases, LayerNorms 1 and 0)
through ``port_from_hf`` and a checkpoint.
Every check that fails raises, so the script exits non-zero and prints no
result line; it never falls back to the CPU or to a plain version.  Each
kernel's launch count is set to 0 right before the path that runs it and
read right after (in ``daemon`` and ``daemon_aia``, by the daemon's
process, reported on SIGUSR2 after its warm-ups and after the calls; in
the bench phases, by the bench's process under ``BENCH_PRELUDE``; in
``remote_call``, kernel 1's by the peer, asked through its probe; in
``parallel``, kernels 1 and 2 by each rank process of the dry run; in
``train``, kernel 1's by the STT trainer's run).  The
bench phases hold checks, not SLAs: their latencies and rates are printed
as measurements.
``--only kernels`` stops after the kernel phases and ``--only attention``
after the first of them (quick build-and-compare runs); ``--only benches``
runs the bench phases, ``stt_ladder`` and ``ckpt_port`` alone after the
build, and ``--phases a,b`` the named ones of them, ``remote_call``,
``cross_i8`` (the kernel phase, ``stt`` and ``stt_cross_i8``),
``parallel``, ``examples`` or ``train``.
They print no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import logging
import math
import os
import sys
import threading
import time
import types
from unittest import mock

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate

ATTN_TOL = 1e-2  # bf16 output: the plain version computes in fp32 from the same bf16 inputs
ATTN_FP32_REL_TOL = 1e-5  # relative L2, fp32 mode: both full fp32, sums in another order
STEP_TOL = 3e-2  # fp32 hidden after 6 layers of bf16 weights; cache rows rounded to bf16
ENC_REL_TOL = 5e-2  # relative L2 error of the 32-layer encoder output, bf16 activations
MEL_REL_TOL = 5e-2  # relative L2 error of one TTS tick's mel chunk (16 chained steps), bf16
# loopback QA's mean similarity on the tiny-real pair, 4 voices x 2 prompts:
# the reference package's on the CPU in fp32 (tests/test_torch_loopback.py
# holds the port's cells equal to it on the reference's draws); the card's
# phase, bf16 on the port's own draws, must reach it less 0.1
LOOPBACK_REF_MEAN = 0.98508
LOOPBACK_BAR = LOOPBACK_REF_MEAN - 0.1


_T0 = time.monotonic()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "at_s": round(time.monotonic() - _T0, 1), **kw}),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def launch_counts() -> dict:
    """Every kernel mode's launches so far (``infernos_tpu_torch.ops``)."""
    from infernos_tpu_torch.ops import launch_counts as counts

    return counts()


def reset_launch_counts() -> None:
    from infernos_tpu_torch.ops import reset_launch_counts as reset

    reset()


# a path's kernel modes: kernel 1 in bf16 or fp32, and kernel 2 by (int8
# weights, fp32 caches); the names of ``ops.launch_counts``.  The int8-direct
# cross-attention kernel (CROSS_KEY) runs only on a path that sets
# ``STTEngineConfig.cross_int8_direct``
ATTN_KEY = {False: "attention", True: "attention_fp32"}
STEP_KEY = {(False, False): "bf16_step", (True, False): "int8_step",
            (False, True): "fp32_step", (True, True): "int8_fp32_step"}
CROSS_KEY = "cross_i8"


def path_launches(c: dict, what: str, fp32: bool, int8: bool = False,
                  cross_i8: bool = False) -> tuple:
    """(kernel-1, kernel-2) launches of a path in its modes, from launch
    counts ``c``: the tiny and tiny-real engines run the fp32 modes, the
    full-width ones the bf16 modes; any launch in another mode fails, and
    so does the int8-direct cross kernel's unless ``cross_i8`` (its count
    is then ``c[CROSS_KEY]``)."""
    mine = (ATTN_KEY[fp32], STEP_KEY[(int8, fp32)], *((CROSS_KEY,) if cross_i8 else ()))
    for k in (*ATTN_KEY.values(), *STEP_KEY.values(), CROSS_KEY):
        check(k in mine or c[k] == 0, f"{what}: {k} kernel launched {c[k]} times, "
                                      f"outside this path's modes {mine}")
    return c[mine[0]], c[mine[1]]


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


def ptxas_summary(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    (mangled name) in one source's ``-Xptxas -v`` report."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur is not None:
            cur["static_smem"] = int(m.group(1))
    return out


def bound_ms(n_bytes: float, n_ops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_flops * 1e3
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
    # the tiny-real encoder's calls: 4 heads of 64 over the 2 s and 5 s
    # buckets (S 100 and 250), one utterance or two
    for B, S in ((1, 100), (1, 250), (2, 250)):
        q, k, v = rnd(B, S, 4 * Dh), rnd(B, S, 4 * Dh), rnd(B, S, 4 * Dh)
        cases.append({"B": B, "S": S, "masked": False, "layout": "[B, S, D]",
                      "heads": 4, "tiny_real": True, "max_abs_err": compare(
                          f"tiny-real B={B} S={S}",
                          attn.fused_attention(q, k, v, n_heads=4),
                          attn.by_heads(attn._plain_attention, q, k, v, n_heads=4))})
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


def phase_attention_fp32(torch, attn):
    """Kernel 1's fp32 mode against its plain version in fp32, relative L2
    within ``ATTN_FP32_REL_TOL``.  Timed, masked and not: whisper-large-v3's
    ``[20, 1500, 64]``, the tiny-real encoder's ``[B * 4, S, 64]`` (S 100
    and 250, off the 64-key tile grid) and the tiny STT trainer's ``[32,
    250, 64]``: ``ms`` (graph replay), ``eager_ms``, the plain version's and
    ``scaled_dot_product_attention``'s on the same fp32 inputs, and the
    bound at the card's fp32 rate, each beside its launch plan
    (``attention.fp32_plan``).  Held, not timed: a shape at each branch of
    the plan (no split, a cluster of 2, 4 and 8, each block shape, S of 1,
    63, 65 and 129), key masks whose last 64-key tile is masked
    whole for some batch rows, and the tiny-real ``[B, S, 256]`` call with
    heads read in place."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(13)
    Dh = 64

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def rel_err(what, got, want):
        torch.cuda.synchronize()
        check(got.dtype == torch.float32, f"fp32 attention {what}: output {got.dtype}")
        err = ((got.double() - want.double()).norm() / want.double().norm()).item()
        check(math.isfinite(err) and err <= ATTN_FP32_REL_TOL,
              f"fp32 attention kernel {what}: relative L2 error {err}")
        return err, (got - want).abs().max().item()

    def plan_of(BH, S):
        plan = attn.fp32_plan(BH, S)
        return {k: plan[k] for k in ("rows", "x", "split", "blocks")}

    def lengths(BH, S, whole_tile: bool):
        lens = torch.randint(S // 2, S + 1, (BH,), generator=g, device="cuda")
        if whole_tile:  # every other row keeps no key of the last tile
            lens[::2] = max(1, (S - 1) // 64 * 64 - 1)
        return torch.where(torch.arange(S, device="cuda")[None] < lens[:, None], 0.0,
                           attn.NEG_INF)

    def held(BH, S, mask):
        q, k, v = rnd(BH, S, Dh), rnd(BH, S, Dh), rnd(BH, S, Dh)
        zeros = torch.zeros((BH, S), device="cuda")
        before = attn.fused_attention.launches
        kern = lambda: attn._kernel_attention(q, k, v, mask)  # noqa: E731
        rel, mae = rel_err(f"[{BH}, {S}, 64] masked={mask is not None} {plan_of(BH, S)}",
                           kern(), attn._plain_attention(q, k, v, zeros if mask is None else mask))
        check(attn.fused_attention.launches == before,
              "fp32 attention: the bf16 kernel's count moved")
        return q, k, v, zeros, kern, rel, mae

    cases = []
    for BH, S in ((20, 1500), (4, 100), (4, 250), (8, 250), (32, 250)):
        for masked in (False, True):
            mask = lengths(BH, S, False) if masked else None
            q, k, v, zeros, kern, rel, mae = held(BH, S, mask)
            q4, k4, v4 = (t[None] for t in (q, k, v))  # [1, BH, S, Dh]
            m4 = None if mask is None else mask[None, :, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)  # noqa: E731
            bms, by = bound_ms(4 * BH * S * Dh * 4 + (BH * S * 4 if masked else 0),
                               4.0 * BH * S * S * Dh, PEAK_FP32_FLOPS)
            cases.append({
                "BH": BH, "S": S, "masked": masked, "plan": plan_of(BH, S),
                "rel_l2_err": rel, "max_abs_err": mae,
                "ms": graph_ms(kern, 20), "eager_ms": cuda_ms(kern, 20),
                "plain_ms": cuda_ms(lambda: attn._plain_attention(
                    q, k, v, zeros if mask is None else mask), 5),
                "library_ms": graph_ms(sdpa, 20), "library_eager_ms": cuda_ms(sdpa, 20),
                "bound_ms": bms, "bound_by": by})
    # each branch of the plan, and masks that leave some rows no key of the
    # last tile, held to the plain version
    branches = [(32, 250), (4, 100), (1, 600), (1, 450), (6, 1), (6, 63), (6, 65), (6, 129),
                (8, 250)]
    seen = set()
    for BH, S in branches:
        plan = plan_of(BH, S)
        seen |= {("split", plan["split"]), ("shape", plan["rows"], plan["x"])}
        for mask in (None, lengths(BH, S, True)):
            rel, mae = held(BH, S, mask)[5:]
            cases.append({"BH": BH, "S": S, "masked": mask is not None,
                          "last_tile_masked": mask is not None, "plan": plan,
                          "rel_l2_err": rel, "max_abs_err": mae})
    want = ({("split", c) for c in attn.FP32_SPLITS}
            | {("shape", *rx) for rx in attn.FP32_SHAPES})
    check(want <= seen, f"fp32 attention: branches of the plan not held: {want - seen}")
    # the tiny-real encoder's own call: [B, S, 4 * 64] read in place, a key
    # mask per utterance
    q, k, v = rnd(2, 250, 4 * Dh), rnd(2, 250, 4 * Dh), rnd(2, 250, 4 * Dh)
    mask = torch.arange(250, device="cuda")[None] < torch.tensor([[250], [130]], device="cuda")
    rel, mae = rel_err("[2, 250, 256] in place",
                       attn.fused_attention(q, k, v, n_heads=4, mask=mask),
                       attn.by_heads(attn._plain_attention, q, k, v, n_heads=4, mask=mask))
    cases.append({"B": 2, "S": 250, "heads": 4, "masked": True, "layout": "[B, S, D]",
                  "plan": plan_of(8, 250), "rel_l2_err": rel, "max_abs_err": mae})
    main = cases[0]  # [20, 1500, 64], no mask
    emit("kernel_attention_fp32", rel_tol=ATTN_FP32_REL_TOL, cases=cases,
         bound_us=main["bound_ms"] * 1e3)
    small = [c for c in cases if c.get("BH") in (4, 8, 32) and "ms" in c]
    return {"name": "encoder_attention_fp32", "route": "cuda",
            "source": "infernos_tpu_torch/csrc/attention_fp32.cu",
            "replaces": "infernos_tpu/ops/attention.py:53 (fp32 inputs)",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "rel_l2_err": max(c["rel_l2_err"] for c in cases),
            **{f"tiny_real_{k}": {f"[{c['BH']}, {c['S']}, 64] masked={c['masked']}": c[k]
                                  for c in small}
               for k in ("ms", "eager_ms", "bound_ms", "library_ms")},
            "tiny_real_plan": {f"[{c['BH']}, {c['S']}, 64]": c["plan"] for c in small},
            **{k: main[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_eager_ms")}}


# -- phase 4: TTS decoder-step kernel -----------------------------------------

def compare_steps(torch, ts, cfg, fw, g, B, T, S, name, lens, pos0, steps=4,
                  cdt=None):
    """``steps`` chained steps of the kernel and of its plain version from the
    same random caches in ``cdt`` (bf16 by default; pos advancing, caches
    carried over), x fp32 on even steps and bf16 on odd ones; checks the
    hidden states, the cache rows written and that no other row changed.
    Returns (hidden error with fp32 x, with bf16 x, cache row error,
    untouched, kernel cache, plain cache, key mask)."""
    from infernos_tpu_torch.models import speecht5 as st5

    Lyr, H, Dh = cfg.decoder_layers, cfg.decoder_attention_heads, cfg.head_dim

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    cdt = cdt or torch.bfloat16
    init = [rnd(Lyr, B, H, T, Dh, dtype=cdt), rnd(Lyr, B, H, T, Dh, dtype=cdt),
            rnd(Lyr, B, H, S, Dh, dtype=cdt), rnd(Lyr, B, H, S, Dh, dtype=cdt)]
    ck = st5.DecoderCache(*(t.clone() for t in init))  # kernel's cache
    cp = st5.DecoderCache(*(t.clone() for t in init))  # plain version's cache
    enc_mask = torch.arange(S, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None]
    pos0 = torch.tensor(pos0, device="cuda")
    h_err = h16_err = row_err = 0.0
    h16_ok = True
    written = torch.zeros((B, T), dtype=torch.bool, device="cuda")
    for it in range(steps):  # chained: pos advances, caches carry over
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
    check(math.isfinite(h_err) and h_err <= STEP_TOL,
          f"{name} kernel: hidden max abs err {h_err} (fp32 x)")
    check(math.isfinite(h16_err) and h16_ok,
          f"{name} kernel: bf16 hidden max abs err {h16_err} (bf16 x) beyond "
          f"{STEP_TOL} + 2^-7 relative")
    check(math.isfinite(row_err) and row_err <= STEP_TOL,
          f"{name} kernel: cache rows max abs err {row_err}")
    check(untouched, f"{name} kernel: cache rows other than pos changed")
    return h_err, h16_err, row_err, untouched, ck, cp, enc_mask


TINY_TIMED_POS = 85  # every slot's position where the tiny-real step is timed


def tiny_real_steps(torch, ts, int8: bool, cdt, timed: bool = False) -> dict:
    """The step kernel against its plain version at the tiny-real TTS
    engine's shapes (D 256, 4 heads, F 768, 3 layers; 8 slots, T 170 and
    S 48, as phase ``rtp_call`` builds it) on the trained weights (fp32,
    packed in bf16 on the card, or quantized), over caches in ``cdt``.
    With ``timed``, the step at pos 85 for every slot with fp32 x (the
    tiny-real engines' mode) is also timed, graph replay and eager,
    beside its bound."""
    from infernos_tpu_torch.models import tiny_real
    from infernos_tpu_torch.models.quant import quantize_params

    params, cfg = tiny_real.load_tiny_tts("gl")[:2]  # fp32, the tiny rule
    fw = ts.pack_fused_weights(quantize_params(params) if int8 else params, cfg)
    check(ts.is_int8(fw) == int8, "tiny-real step: packed weights in the wrong mode")
    g = torch.Generator(device="cuda").manual_seed(9)
    B = 8
    h_err, h16_err, row_err, _, ck, _, enc_mask = compare_steps(
        torch, ts, cfg, fw, g, B, RTP_TTS_STEPS, RTP_TTS_TOKENS, "tiny-real step",
        lens=[48, 1, 20, 48, 7, 33, 48, 12], pos0=[0, 169, 1, 80, 100, 37, 150, 7],
        cdt=cdt)
    out = {"tiny_real_hidden_max_abs_err": h_err,
           "tiny_real_bf16_hidden_max_abs_err": h16_err,
           "tiny_real_cache_rows_max_abs_err": row_err}
    if timed:
        pos = torch.full((B,), TINY_TIMED_POS, device="cuda")
        x = torch.randn((B, 1, cfg.hidden_size), generator=g, device="cuda")
        step = lambda: ts.fused_decode_step(None, cfg, x, ck, pos, enc_mask, packed=fw)
        bms, by = bound_ms(ts.step_bytes(fw, ck, pos, B), ts.step_ops(fw, ck, pos, B))
        out.update(tiny_real_ms=graph_ms(step, 50), tiny_real_eager_ms=cuda_ms(step, 50),
                   tiny_real_bound_ms=bms, tiny_real_bound_by=by,
                   tiny_real_timed_pos=TINY_TIMED_POS)
    return out


WIDE_SLOTS = (40, 48)  # beyond the grid kernel's MAX_B: a launch per group of 32


def wide_steps(torch, ts, cfg, fw, g, name: str, key: str, cdt) -> dict:
    """The step kernel against its plain version at 40 and 48 slots (over
    bf16 caches two launches a step, groups of 32 and the rest, each on its
    slot slice of the same caches; over fp32 caches one launch of five or
    six clusters), two chained steps at full width; and each width's
    device time per step (graph replay)."""
    out = {}
    fp32 = cdt == torch.float32
    for B in WIDE_SLOTS:
        T, S = 512, 96
        lens = [96, 1] + [(7 * i) % S + 1 for i in range(B - 2)]
        pos0 = [0, T - 1] + [(37 * i) % (T - 2) for i in range(B - 2)]
        before = launch_counts()
        h_err, h16_err, row_err, untouched, ck, _, enc_mask = compare_steps(
            torch, ts, cfg, fw, g, B, T, S, f"{name} B={B}", lens=lens, pos0=pos0, steps=2,
            cdt=cdt)
        moved = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        n = 2 * ts.launches_per_step(B, fp32)
        check(moved == {key: n},
              f"{name} B={B}: launch counts moved by {moved}, want {key} {n} in 2 steps")
        pos = torch.full((B,), 256, device="cuda")
        x = torch.randn((B, 1, cfg.hidden_size), generator=g, device="cuda").to(torch.bfloat16)
        out[B] = {"hidden_max_abs_err": h_err, "bf16_hidden_max_abs_err": h16_err,
                  "cache_rows_max_abs_err": row_err, "other_rows_untouched": untouched,
                  "launches_per_step": ts.launches_per_step(B, fp32),
                  "ms_per_step": graph_ms(lambda: ts.fused_decode_step(
                      None, cfg, x, ck, pos, enc_mask, packed=fw), 20)}
    return out


def tts_engine_wide(torch, ts, slots: int = 40, ticks: int = 6) -> int:
    """A ``TTSEngine`` of ``slots`` slots on the card (tiny-real weights,
    fp32, Griffin-Lim) runs ``ticks`` ticks with ``slots`` sessions: every
    step of all slots is one launch of the fp32-cache mode (a cluster per
    group of at most 8 slots), counted from 0 here, and every session has
    finite audio by the end.  Returns the launches."""
    from infernos_tpu_torch.models import tiny_real
    from infernos_tpu_torch.serving import tts_engine as tts

    tp, tcfg, vp, vcfg, tok, table = tiny_real.load_tiny_tts("gl", "cuda")
    eng = tts.TTSEngine(tp, tcfg, vp, vcfg, tts.TTSEngineConfig(
        batch_slots=slots, max_text_tokens=RTP_TTS_TOKENS, max_steps=RTP_TTS_STEPS,
        stop_threshold=0.5, dtype=torch.float32), device="cuda")
    chunks = {i: [] for i in range(slots)}
    for i in range(slots):
        eng.start_session(np.asarray(tok(CALL_LINES[i % 2][4]), np.int32), table[i % len(table)],
                          chunks[i].append)
    calls = []
    step = mock.patch.object(tts, "fused_decode_step",
                             side_effect=lambda *a, **k: calls.append(1) or
                             ts.fused_decode_step(*a, **k))
    reset_launch_counts()  # this path starts here
    t0 = time.perf_counter()
    with step:
        for _ in range(ticks):
            eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches(launch_counts(), f"tts {slots} slots", fp32=True)[1]
    per_step = ts.launches_per_step(slots, fp32_caches=True)
    check(calls and launches == per_step * len(calls),
          f"tts {slots} slots: {launches} launches for {len(calls)} steps")
    for i, cs in chunks.items():
        audio = [c for c in cs if c is not None]
        check(audio and all(np.isfinite(c).all() for c in audio),
              f"tts {slots} slots: session {i} has no finite audio after {ticks} ticks")
    emit("tts_wide_engine", slots=slots, sessions=slots, ticks=ticks, steps=len(calls),
         launches=launches, launches_per_step=per_step, wall_s=wall,
         model="tiny-real SpeechT5 (fp32, Griffin-Lim)")
    return launches


STEP_MODE_NAMES = {(False, False): "tts_decode_step", (True, False): "tts_decode_step_int8",
                   (False, True): "tts_decode_step_fp32",
                   (True, True): "tts_decode_step_int8_fp32"}


def phase_tts_step(torch, st5, ts, int8=False, fp32=False, bf16_ms=None):
    """The decoder-step kernel against its plain version at full width; with
    ``int8`` the weights are quantized first (int8 codes + fp32 scales) and
    the bf16 kernel's time (``bf16_ms``) is printed beside the others; with
    ``fp32`` the caches are fp32 (the tiny and tiny-real engines' mode,
    the cluster kernel of ``csrc/tts_step_cluster.cu``).  Also at the
    tiny-real engine's shapes on its trained weights, in the same mode,
    where the fp32-cache modes are also timed (pos 85: ``tiny_real_ms``,
    ``tiny_real_eager_ms`` and ``tiny_real_bound_ms`` beside the full-width
    numbers).  Returns the kernels row and the timed call (for the launch
    count)."""
    from infernos_tpu_torch.models.quant import quantize_params

    cdt = torch.float32 if fp32 else torch.bfloat16
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
    name, key = STEP_MODE_NAMES[(int8, fp32)], STEP_KEY[(int8, fp32)]
    B, T, S = 8, 512, 96
    before = launch_counts()
    errs = compare_steps(torch, ts, cfg, fw, g, B, T, S, name,
                         lens=[96, 1, 50, 96, 17, 80, 96, 33],
                         pos0=[0, 511, 1, 255, 100, 37, 400, 7], cdt=cdt)
    moved = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    check(moved == {key: 4}, f"{name}: launch counts moved by {moved}, want {key} 4")
    h_err, h16_err, row_err, untouched, ck, cp, enc_mask = errs
    tiny = tiny_real_steps(torch, ts, int8, cdt, timed=fp32)
    wide = wide_steps(torch, ts, cfg, fw, g, name, key, cdt)

    pos = torch.tensor([256] * B, device="cuda")  # the bound's reference point
    x = torch.randn((B, 1, cfg.hidden_size), generator=g, device="cuda").to(
        torch.float32 if fp32 else torch.bfloat16)  # as the engines of the mode give it
    step = lambda: ts.fused_decode_step(None, cfg, x, ck, pos, enc_mask, packed=fw)
    # device time (50 steps replayed from one CUDA graph); eager_ms is the
    # same call made from Python back to back, host-bound if the host is slower
    ms = graph_ms(step, 50)
    eager_ms = cuda_ms(step, 50)
    plain_ms = cuda_ms(lambda: ts._plain_decode_step(fw, cfg, x, cp, pos, enc_mask), 10)
    # operations at the bf16 tensor-core rate in every mode (the products
    # take bf16 x and bf16 or int8 weights); the bytes set the bound
    n_bytes = ts.step_bytes(fw, ck, pos, B)
    bms, by = bound_ms(n_bytes, ts.step_ops(fw, ck, pos, B))
    extra = {"bf16_ms_per_step": bf16_ms} if bf16_ms is not None else {}
    emit("kernel_" + name.replace("tts_decode_", "tts_"), tol=STEP_TOL,
         cache_dtype=str(cdt).replace("torch.", ""),
         hidden_max_abs_err=h_err, bf16_hidden_max_abs_err=h16_err,
         bf16_tol=f"{STEP_TOL} + 2^-7 relative",
         cache_rows_max_abs_err=row_err, other_rows_untouched=untouched,
         ms_per_step=ms, eager_ms_per_step=eager_ms, plain_ms_per_step=plain_ms,
         launches_per_step=ts.launches_per_step(B, fp32),
         step_bytes=n_bytes,
         weight_bytes=sum(t.numel() * t.element_size() for t in fw.values()),
         bound_us=bms * 1e3, bound_by=by, B=B, T=T, S=S, pos=256, **tiny, **extra,
         wide=wide)
    mode = (" (int8w mode, :128)" if int8 else "") + (" (fp32 caches, :677)" if fp32 else "")
    tiny_t = {k: tiny[k] for k in ("tiny_real_ms", "tiny_real_eager_ms", "tiny_real_bound_ms",
                                   "tiny_real_bound_by") if k in tiny}
    return {"name": name, "route": "cuda",
            "source": "infernos_tpu_torch/csrc/" + ("tts_step_cluster.cu" if fp32
                                                    else "tts_step.cu"),
            "replaces": "infernos_tpu/ops/tts_step.py:727" + mode,
            "max_abs_err": max(h_err, row_err, tiny["tiny_real_hidden_max_abs_err"],
                               tiny["tiny_real_cache_rows_max_abs_err"],
                               *(w[k] for w in wide.values()
                                 for k in ("hidden_max_abs_err", "cache_rows_max_abs_err"))),
            "bf16_hidden_max_abs_err": h16_err,
            "ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, **tiny_t}, step


# -- phase 4b: the int8-direct cross-attention kernel --------------------------

# the kernel against its plain version on the same CUDA tensors: the output
# within one bf16 step (2^-7) or 1e-4 in fp32, relative L2 (the int codes
# and sums are exact; the softmax sums in another order, which moves a
# weight's code by one in rare ties); at most one weight code in a thousand
# one apart (at least one allowed)
CROSS_I8_REL_TOL = {"bf16": 2 ** -7, "fp32": 1e-4}
CROSS_I8_CODE_SHARE = 1e-3
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
# one decode step's logits at full width, bf16, on the cache the path left:
# the direct mode against the dequantize path.  Derived on the CPU from the
# reference's own gap (tests/test_torch_cross_i8.py, large-v3 width, 4 of
# 32 decoder layers, bf16: 5.27e-3): twice it, grown as the square root of
# the depth to 32 layers, is 0.030; the bound is 0.04
CROSS_I8_LOGITS_REL_TOL = 0.04
CROSS_I8_MAIN = (16, 20, 1500)  # large-v3's decode step: 16 slots, 20 heads, S 1500
# the STT engine's masks (serving/stt_engine.py masks each slot to its
# bucket's encoder length): 8, 16 and 30 s buckets and an empty slot
XI8_ENGINE_LENS = (400, 800, 1500, 0)
# shapes whose positions overflow the shared memory of the plan that keeps
# every block resident: 528 rows of 14,000 take blocks of 64 threads, 320
# rows of 30,000 a cluster of 4 (cross_i8_plan)
XI8_STEPPED = ((24, 22, 14000), (16, 20, 30000))


def cross_i8_case(torch, g, B, H, S, dtype, masked):
    """q ``[B, H, 1, 64]`` scaled as the decode step scales it, int8 caches
    (``whisper.quantize_kv``) of positions of unlike magnitude, and, if
    ``masked``, per-slot lengths: random with every fourth slot empty (a
    lone slot keeps half), or, where ``masked`` is a tuple of lengths, those
    cycled over the slots (the STT engine's masks: ``XI8_ENGINE_LENS``)."""
    from infernos_tpu_torch.models import whisper as wsp

    q = (torch.randn((B, H, 1, 64), generator=g, device="cuda") * 64 ** -0.5).to(dtype)
    k, v = (torch.randn((B, H, S, 64), generator=g, device="cuda")
            * (0.2 + 2.8 * torch.rand((B, H, S, 1), generator=g, device="cuda"))
            for _ in range(2))
    mask = None
    if isinstance(masked, tuple):
        lens = torch.tensor([masked[b % len(masked)] for b in range(B)], device="cuda")
        mask = torch.arange(S, device="cuda")[None] < lens[:, None]
    elif masked:
        lens = torch.randint(0, S + 1, (B,), generator=g, device="cuda")
        lens[::4] = 0
        if B == 1:
            lens[0] = S // 2 + 1
        mask = torch.arange(S, device="cuda")[None] < lens[:, None]
    return q, wsp.quantize_kv(k), wsp.quantize_kv(v), mask


def dequantize_core(torch, wsp, q, kc, vc, mask):
    """What the direct mode replaces: ``dequantize_kv`` of K and V and the
    core of ``layers.cross_attention_step`` between its projections."""
    k, v = wsp.dequantize_kv(kc, q.dtype), wsp.dequantize_kv(vc, q.dtype)
    logits = torch.matmul(q, k.transpose(-1, -2))
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def cross_i8_held(torch, xi8, q, kc, vc, mask, what: str, plan=None, want=None):
    """The kernel (under ``plan``, else the wrapper's) and its plain version
    (``want``: its output and codes, if already computed) on the same
    tensors; fails unless the output is finite and within
    ``CROSS_I8_REL_TOL`` (relative L2) and the weights' codes agree
    (``CROSS_I8_CODE_SHARE``, one apart at most).  Returns the kernel's
    output, the plain version's output and codes, and the figures."""
    B, H, S = q.shape[0], q.shape[1], kc["q"].shape[2]
    codes = torch.empty((B, H, S), dtype=torch.int8, device=q.device)
    got = xi8._kernel_cross_attention_i8(q, kc, vc, mask, codes=codes, plan=plan)
    if want is None:
        out, _, want_codes = xi8._plain_cross_attention_i8(q, kc, vc, mask, return_codes=True)
        want = out, want_codes
    want, want_codes = want
    torch.cuda.synchronize()
    diff = (codes.int() - want_codes.int()).abs()
    stats = {"rel_l2": rel_l2_t(torch, got, want),
             "max_abs_err": (got.float() - want.float()).abs().max().item(),
             "codes_differing": int((diff > 0).sum().item()), "codes": codes.numel(),
             "code_max_diff": int(diff.max().item())}
    tol = CROSS_I8_REL_TOL["bf16" if q.dtype == torch.bfloat16 else "fp32"]
    check(bool(torch.isfinite(got.float()).all()), f"cross_i8 kernel {what}: not finite")
    check(stats["rel_l2"] <= tol, f"cross_i8 kernel {what}: {stats}, rel L2 over {tol}")
    check(stats["code_max_diff"] <= 1 and stats["codes_differing"]
          <= max(1, int(CROSS_I8_CODE_SHARE * stats["codes"])),
          f"cross_i8 kernel {what}: {stats}, the weights' codes differ")
    return got, (want, want_codes), stats


def phase_cross_i8(torch):
    """The int8-direct cross-attention kernel against its plain version at
    S 1, 63 and 1500 and B * H of 1 and 320, unmasked, with random
    per-slot lengths and with the STT engine's (``XI8_ENGINE_LENS``: whole
    ranges of a cluster and whole rows masked), in bf16 (and fp32 at the
    main shape), under the wrapper's plan (``cross_i8_plan``) and under
    clusters of 1, 2, 4 and 8 blocks, and at the shapes ``XI8_STEPPED``
    under the wrapper's plan: the output's relative L2 and the weights'
    codes that differ.  At the main shape ``[16, 20, 1500, 64]``
    in bf16, unmasked and at the engine's masks, each with its plan: device
    ms (graph replay of one input, which the 50 MB L2 partly keeps between
    calls; ``cold_ms``: cycling through four, 260 MB, as the decode step
    finds each layer's cache) and eager ms beside the bound (the bytes this data
    needs: K codes and scales of valid positions, V scales where a weight
    can be non-zero, V codes where a weight's code is not 0, q and the
    output; ``ops/cross_attention_i8_ablate.py`` ``needed_bytes``); unmasked
    also the plain version and the dequantize path it replaces at the same
    shapes (``dequantize_ms``).  The kernels row carries the plan, the
    registers and the static shared memory (phase ``build``)."""
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.ops import build
    from infernos_tpu_torch.ops import cross_attention_i8 as xi8
    from infernos_tpu_torch.ops.cross_attention_i8_ablate import needed_bytes

    g = torch.Generator(device="cuda").manual_seed(11)
    cases, timed = [], {}
    shapes = [(16, 20, S) for S in (1500, 63, 1)] + [(1, 1, S) for S in (1500, 63, 1)]
    for (B, H, S) in shapes:
        for dtype in (("bf16", "fp32") if (B, H, S) == CROSS_I8_MAIN else ("bf16",)):
            for masked in (False, True, XI8_ENGINE_LENS):
                tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
                q, kc, vc, mask = cross_i8_case(torch, g, B, H, S, tdt, masked)
                want = None
                for cluster in (None, 1, 2, 4, 8):
                    plan = None if cluster is None else xi8.cross_i8_plan(B * H, S,
                                                                          cluster=cluster)
                    shown = plan or xi8.cross_i8_plan(B * H, S)
                    case = {"B": B, "H": H, "S": S, "dtype": dtype,
                            "masked": "engine" if isinstance(masked, tuple) else masked,
                            "plan": "wrapper" if plan is None else "forced",
                            **{k: shown[k] for k in ("cluster", "threads")}}
                    got, want, stats = cross_i8_held(torch, xi8, q, kc, vc, mask, str(case),
                                                     plan=plan, want=want)
                    case.update(stats)
                    cases.append(case)
                if (B, H, S) != CROSS_I8_MAIN or dtype != "bf16" or masked is True:
                    continue
                name = "main" if masked is False else "engine"
                plan = xi8.cross_i8_plan(B * H, S)
                n_bytes, n_ops, live = needed_bytes(q, mask, want[1])
                kernel = lambda: xi8._kernel_cross_attention_i8(q, kc, vc, mask)  # noqa: E731
                others = [cross_i8_case(torch, g, B, H, S, tdt, masked) for _ in range(3)]
                calls = itertools.cycle([kernel] + [
                    (lambda c: lambda: xi8._kernel_cross_attention_i8(*c))(c) for c in others])
                row = timed[name] = {
                    "ms": graph_ms(kernel, 50), "eager_ms": cuda_ms(kernel, 50),
                    "cold_ms": graph_ms(lambda: next(calls)(), 48),
                    "v_rows_needed": live,
                    "plan": {k: plan[k] for k in ("cluster", "threads", "blocks", "rows",
                                                  "smem_bytes")}}
                del others
                row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
                if masked is False:
                    n = B * H * S
                    row["bound_all_rows_ms"] = bound_ms(
                        2 * n * 64 + 2 * n * 4 + 2 * 2 * B * H * 64, n_ops, PEAK_INT8_OPS)[0]
                    dequant = lambda: dequantize_core(torch, wsp, q, kc, vc, None)  # noqa: E731
                    row["plain_ms"] = cuda_ms(lambda: xi8._plain_cross_attention_i8(
                        q, kc, vc), 5)
                    row["dequantize_ms"] = graph_ms(dequant, 20)
                    row["dequantize_eager_ms"] = cuda_ms(dequant, 20)
                    row["dequantize_rel_l2"] = rel_l2_t(torch, got, dequant())
    for (B, H, S) in XI8_STEPPED:
        q, kc, vc, mask = cross_i8_case(torch, g, B, H, S, torch.bfloat16, False)
        plan = xi8.cross_i8_plan(B * H, S)
        case = {"B": B, "H": H, "S": S, "dtype": "bf16", "masked": False, "plan": "wrapper",
                **{k: plan[k] for k in ("cluster", "threads")}}
        case.update(cross_i8_held(torch, xi8, q, kc, vc, mask, str(case))[2])
        cases.append(case)
        del q, kc, vc
    build_info = ptxas_summary(build.LOGS.get("cross_attention_i8", ""))
    emit("kernel_cross_i8", tol=CROSS_I8_REL_TOL, code_share=CROSS_I8_CODE_SHARE,
         cases=cases, timed=timed, ptxas=build_info)
    main, engine = timed["main"], timed["engine"]
    return {"name": "cross_attention_i8", "route": "cuda",
            "source": "infernos_tpu_torch/csrc/cross_attention_i8.cu",
            "replaces": "infernos_tpu/models/layers.py:431",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "library_ms": None,  # no single PyTorch call; dequantize_ms is the path it replaces
            **{k: main[k] for k in ("ms", "cold_ms", "eager_ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_all_rows_ms", "dequantize_ms",
                                    "dequantize_eager_ms", "plan")},
            "engine_masks_ms": engine["ms"], "engine_masks_cold_ms": engine["cold_ms"],
            "engine_masks_bound_ms": engine["bound_ms"],
            "registers": sorted({k["registers"] for k in build_info.values()
                                 if "registers" in k}),
            "static_smem": sorted({k["static_smem"] for k in build_info.values()
                                   if "static_smem" in k})}


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
    reset_launch_counts()  # the main path starts here
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
    launches = path_launches(launch_counts(), "stt", fp32=False)[0]  # right after the path
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
    return launches, params, results


def phase_stt_cross_i8(torch, params, dequant_results):
    """The ``stt`` phase's engine with ``cross_int8_direct=True`` on the
    params that phase made, serving its four requests: 32 launches of the
    int8-direct cross kernel (one per decoder layer) per decode step and
    kernel 1 once per encoder layer per encode, no other mode.  Then, on
    the cache the path left (the self caches copied), one decode step's
    logits of the served slots, the direct mode against the dequantize path
    (within ``CROSS_I8_LOGITS_REL_TOL``); in that step each layer's kernel
    call is held to the plain version on the same inputs, as the kernel
    phase holds it (``CROSS_I8_REL_TOL``, ``CROSS_I8_CODE_SHARE``).  The
    logits of the step through the plain version are printed beside them:
    the bf16 model carries a one-step rounding difference through 32
    layers, so that gap measures the model's sensitivity, not the kernel."""
    import dataclasses

    from infernos_tpu_torch.models import layers as L
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.ops import cross_attention_i8 as xi8
    from infernos_tpu_torch.serving import stt_engine as stt

    cfg = wsp.WhisperConfig()
    ecfg = stt.STTEngineConfig(dtype=torch.bfloat16, max_new_tokens=16,
                               cross_int8_direct=True)
    eng = stt.STTEngine(params, cfg, ecfg)
    check(eng.device.type == "cuda", "stt engine is not on the card")
    rng = np.random.default_rng(0)  # the stt phase's requests
    audios = [synth_audio(rng, s) for s in (2.0, 3.5, 5.25, 8.0)]
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    eng.encode_ms.clear()
    steps_run = []
    decode_step = wsp.decode_step

    def counted(*a, **kw):
        steps_run.append(kw.get("cross_direct_int8"))
        return decode_step(*a, **kw)

    results = {}
    reset_launch_counts()  # the path starts here
    with mock.patch.object(wsp, "decode_step", counted):
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
    c = launch_counts()  # right after the path
    attn_launches, _ = path_launches(c, "stt_cross_i8", fp32=False, cross_i8=True)
    launches = c[CROSS_KEY]
    check(len(results) == len(audios), f"stt_cross_i8: {len(results)} of {len(audios)} results")
    check(all(steps_run), "stt_cross_i8: a decode step ran without the direct mode")
    check(launches == cfg.decoder_layers * len(steps_run) and launches > 0,
          f"stt_cross_i8: the cross kernel launched {launches} times in "
          f"{len(steps_run)} decode steps, want {cfg.decoder_layers} a step")
    check(attn_launches == cfg.encoder_layers * len(audios),
          f"stt_cross_i8: attention kernel launched {attn_launches} times")
    for i, r in results.items():
        check(len(r.tokens) <= ecfg.max_new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.tokens)
              and math.isfinite(r.avg_logprob) and math.isfinite(r.no_speech_prob),
              f"stt_cross_i8 request {i}: bad result")

    served = eng.enc_mask.any(dim=1)
    check(int(served.sum()) >= len(audios), "stt_cross_i8: the served slots' masks are gone")

    def one_step(direct, core=None):
        cache = dataclasses.replace(eng.cache, self_k=eng.cache.self_k.clone(),
                                    self_v=eng.cache.self_v.clone())
        patch = (mock.patch.object(L, "cross_attention_i8", core) if core
                 else contextlib.nullcontext())
        with torch.no_grad(), patch:
            return wsp.decode_step(params, cfg, eng.cur_tok, cache, eng.pos,
                                   enc_mask=eng.enc_mask, cross_direct_int8=direct)[served]

    layers = []  # each layer's kernel call against the plain version on its inputs

    def held(q, k_c, v_c, kv_mask=None):
        got, _, stats = cross_i8_held(torch, xi8, q, k_c, v_c, kv_mask,
                                      f"stt_cross_i8 layer {len(layers)}")
        layers.append(stats)
        return got

    direct = one_step(True, held)
    vs_dequant = rel_l2_t(torch, direct, one_step(False))
    vs_plain = rel_l2_t(torch, direct, one_step(True, xi8._plain_cross_attention_i8))
    check(bool(torch.isfinite(direct.float()).all()), "stt_cross_i8: logits not finite")
    check(vs_dequant <= CROSS_I8_LOGITS_REL_TOL,
          f"stt_cross_i8: direct logits {vs_dequant} from the dequantize path's")
    check(len(layers) == cfg.decoder_layers, f"stt_cross_i8: {len(layers)} layers held")
    same = [results[i].tokens == dequant_results[i].tokens for i in range(len(audios))]
    emit("stt_cross_i8", model="whisper-large-v3", warmup_s=warmup_s, steps=steps,
         decode_steps=len(steps_run), wall_s=wall_s, cross_i8_launches=launches,
         attention_launches=attn_launches, encode_ms=eng.encode_ms,
         latency_s=[results[i].inf_time for i in range(len(audios))],
         n_tokens=[len(results[i].tokens) for i in range(len(audios))],
         avg_logprob=[results[i].avg_logprob for i in range(len(audios))],
         dequant_avg_logprob=[dequant_results[i].avg_logprob for i in range(len(audios))],
         tokens_as_dequantize_path=same,
         logits_rel_l2_vs_dequantize=vs_dequant, logits_rel_tol=CROSS_I8_LOGITS_REL_TOL,
         logits_rel_l2_vs_plain=vs_plain, slots_compared=int(served.sum()),
         layers_rel_l2_max=max(x["rel_l2"] for x in layers),
         layers_codes_differing=sum(x["codes_differing"] for x in layers))
    return launches


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
    reset_launch_counts()  # the main path starts here
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
    launches = path_launches(launch_counts(), "tts", fp32=False)[1]  # right after the path
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
         step_launches=launches, launches_per_step=ts.launches_per_step(ecfg.batch_slots),
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
    reset_launch_counts()
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
    c = launch_counts()
    if errors:
        raise errors[0]
    # full width: kernel 1 in bf16, kernel 2 with int8 weights over bf16 caches
    attn_launches, int8_steps = path_launches(c, "turn", fp32=False, int8=True)
    bf16_steps = c["bf16_step"]
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


# -- phase 8: a two-leg call over RTP on the trained tiny-real pair ------------

RTP_TTS_STEPS = 170  # tiny-real TTSEngineConfig (cluster/model_actors.py:156-160)
RTP_TTS_TOKENS = 48
ACC_MIN = 0.6  # word accuracy per direction (tests/test_lt_bilingual_e2e.py:162-163)
SILENT = 1e-3  # a sample at or under this magnitude is silence (the same test)
# (speaker, listener, STT language, TTS language, text, render seed, what the
# listener must hear): the texts and seeds of test_lt_bilingual_e2e.py
CALL_LINES = (("alice", "bob", "en", "pt", "please help now", 5, "favor ajuda agora"),
              ("bob", "alice", "pt", "en", "quero ajuda hoje", 7, "want help today"))


def render_speech(text: str, seed: int) -> np.ndarray:
    """``text`` spoken in the synthetic speech language by a random speaker
    from ``seed`` (the port's ``audio.speechlang``), at 8 kHz as a phone
    sends it."""
    from infernos_tpu_torch.audio import speechlang
    from infernos_tpu_torch.audio.chunk import AudioChunk

    rng = np.random.default_rng(seed)
    a16 = speechlang.render_text(rng, text, speechlang.Speaker.random(rng))
    return AudioChunk(a16, 16000).resample(8000).audio


def active_region(audio: np.ndarray, margin: int = 800) -> np.ndarray:
    """``audio`` without its leading and trailing silence."""
    idx = np.flatnonzero(np.abs(audio) > SILENT)
    if idx.size == 0:
        return audio[:0]
    return audio[max(0, idx[0] - margin): idx[-1] + margin]


def word_acc(ref: str, hyp: str) -> float:
    rw, hw = ref.split(), hyp.split()
    return sum(a == b for a, b in zip(rw, hw)) / max(len(rw), 1)


def transcribe(stt_eng, audio8k: np.ndarray, lang: str) -> str:
    """One request to ``stt_eng``, stepped here (its driver is stopped)."""
    from infernos_tpu_torch.audio.chunk import AudioChunk
    from infernos_tpu_torch.serving.stt_engine import STTRequest

    out = []
    a16 = AudioChunk(audio8k, 8000).resample(16000).audio
    stt_eng.submit(STTRequest(audio=a16, text_cb=out.append, lang=lang))
    while stt_eng.step():
        pass
    return out[0].text if out else ""


def tiny_real_engines(device=None):
    """The tiny-real pair through the port's loaders, set up as the
    reference's actors start it: an ``STTEngine`` of 8 slots on 2 s and 5 s
    buckets, and a dense ``TTSEngine`` of 8 slots, 48 text tokens, 170 steps,
    stop threshold 0.5, on Griffin-Lim; fp32 on every device, as the
    reference serves them.  Returns (stt engine, tts engine, tts tokenizer,
    speaker bank)."""
    from infernos_tpu_torch.models import tiny_real
    from infernos_tpu_torch.serving import stt_engine as stt
    from infernos_tpu_torch.serving import tts_engine as tts
    from infernos_tpu_torch.serving.speakers import SpeakerBank

    sp, scfg, stok, secfg = tiny_real.load_tiny_stt(device)
    stt_eng = stt.STTEngine(sp, scfg, secfg, detokenize=stok.detokenize, device=device)
    tp, tcfg, vp, vcfg, ttok, table = tiny_real.load_tiny_tts("gl", device)
    ecfg = tts.TTSEngineConfig(batch_slots=8, max_text_tokens=RTP_TTS_TOKENS,
                               max_steps=RTP_TTS_STEPS, stop_threshold=0.5,
                               dtype=tiny_real.serving_dtype(stt_eng.device, tiny=True))
    tts_eng = tts.TTSEngine(tp, tcfg, vp, vcfg, ecfg, device=device)
    return stt_eng, tts_eng, ttok, SpeakerBank(table)


class RtpFarEnd:
    """The phone at the far end of one leg: a UDP socket on 127.0.0.1 that
    streams G.711 mu-law RTP to its leg's endpoint every 20 ms -- silence,
    or the speech it is given -- and keeps every packet that comes back in
    ``rx_packets``, as the SIP phones of ``bench.phone`` do."""

    def __init__(self, name: str):
        import socket

        from infernos_tpu_torch.audio.codecs import G711Codec
        from infernos_tpu_torch.media.rtp import RTPPacketizer

        self.name = name
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.05)
        self.addr = self.sock.getsockname()
        self.codec = G711Codec()
        self.rtp = RTPPacketizer(8000, 20)
        self.lock = threading.Lock()
        self.rx_packets = []  # (arrival time, RTP packet) of every packet received
        self.sent = 0
        self._speech = b""
        self.speech_last = None  # send time of the last speech packet
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=f, name=f"far-{name}-{k}", daemon=True)
                         for k, f in (("tx", self._send_loop), ("rx", self._recv_loop))]
        self.dest = None

    def start(self, dest) -> None:
        self.dest = dest
        for t in self._threads:
            t.start()

    def speak(self, audio8k: np.ndarray) -> None:
        payload = self.codec.encode(audio8k)
        with self.lock:
            self._speech = payload + self.codec.silence(-len(payload) % FRAME_BYTES)
            self.speech_last = None

    def speaking(self) -> bool:
        with self.lock:
            return bool(self._speech)

    def _send_loop(self) -> None:
        t0, k = time.monotonic(), 0
        while not self._stop.is_set():
            with self.lock:
                frame, self._speech = self._speech[:FRAME_BYTES], self._speech[FRAME_BYTES:]
            speech = bool(frame)
            self.sock.sendto(self.rtp.next_pkt(
                FRAME_BYTES, self.codec.ptype, frame or self.codec.silence(FRAME_BYTES)),
                self.dest)
            self.sent += 1
            if speech:
                with self.lock:
                    self.speech_last = time.monotonic()
            k += 1
            lag = t0 + k * 0.020 - time.monotonic()
            if lag > 0:
                time.sleep(lag)

    def _recv_loop(self) -> None:
        import socket

        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                return
            self.rx_packets.append((time.monotonic(), data))

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=2.0)
        self.sock.close()


def rx_audio(phone, n_before: int = 0) -> np.ndarray:
    """The audio of the RTP packets ``phone`` (an ``RtpFarEnd``, or a
    ``FakePhone`` or ``FarEnd`` of ``bench.phone``) received after its
    first ``n_before``."""
    from infernos_tpu_torch.media.rtp import RTPPacket

    pkts = list(phone.rx_packets[n_before:])
    if not pkts:
        return np.zeros(0, np.float32)
    return np.concatenate([phone.codec.decode(RTPPacket.parse(d).payload)
                           for _, d in pkts])


def first_sound_at(phone, n_before: int = 0):
    """Arrival time of the first packet after the first ``n_before`` that
    holds a sample above silence, or None."""
    from infernos_tpu_torch.media.rtp import RTPPacket

    for t, d in list(phone.rx_packets[n_before:]):
        if np.abs(phone.codec.decode(RTPPacket.parse(d).payload)).max() > SILENT:
            return t
    return None


def sip_options(addr, timeout: float = 2.0):
    """The status code a SIP ``OPTIONS`` to ``addr`` is answered with, or
    None when nothing answers within ``timeout`` seconds."""
    import asyncio

    from infernos_tpu_torch.sip.message import NameAddr, SipURI
    from infernos_tpu_torch.sip.stack import SIPStack

    async def ask():
        stack = SIPStack(("127.0.0.1", 0))
        await stack.start()
        try:
            msg = stack.make_request("OPTIONS", SipURI(host=addr[0], port=addr[1]),
                                     NameAddr(SipURI(user="probe", host="127.0.0.1")),
                                     NameAddr(SipURI(host=addr[0])))
            return (await stack.send_request(msg, tuple(addr), timeout=timeout)).code
        except (TimeoutError, asyncio.TimeoutError, OSError):
            return None
        finally:
            stack.close()

    return asyncio.run(ask())


def drive_rtp_call(stt_eng, tts_eng, tts_tok, bank, device=None,
                   lines=CALL_LINES) -> dict:
    """One two-leg call over real UDP on 127.0.0.1, one direction after the
    other: the speaker's far end streams its rendered speech as G.711 RTP
    into its leg's ``RTPEndpoint``; the shared ``RTPIngest`` runs the jitter
    buffer and the VAD (``default_vad_factory``: ``NeuralVAD`` on
    ``device``); each segment goes through ``STTSession`` (the speaker's
    language) -> T2T -> numbers to words -> sentence regrouping ->
    ``TTSSession`` -> the listener's endpoint and its writer (the native
    pacer unless ``INFERNOS_NATIVE_PACER=0``) -> RTP to the listener's far
    end.  Engines are stepped by ``EngineDriver``s; the sessions are wired
    by hand, as the LiveTranslator app wires them.  Returns what each
    direction saw and the media plane's facts; raises on a failure on any
    thread, a driver crash or a direction that does not finish."""
    from infernos_tpu_torch.audio.chunk import AudioChunk
    from infernos_tpu_torch.audio.codecs import G711Codec
    from infernos_tpu_torch.media import native
    from infernos_tpu_torch.media.endpoint import RTPEndpoint, RTPParams
    from infernos_tpu_torch.media.ingest import AudioInput, RTPIngest, default_vad_factory
    from infernos_tpu_torch.media.udp import RTPPortAllocator
    from infernos_tpu_torch.serving import sessions as ses
    from infernos_tpu_torch.serving.driver import EngineDriver
    from infernos_tpu_torch.t2t import (NumbersToWords, Translator,
                                        regroup_sentences, sent_split)
    from infernos_tpu_torch.t2t.lexicon import LexiconBackend
    from infernos_tpu_torch.utils.platform import default_device

    # a direction's deadline: the plain fp32 path on the CPU is the slower one
    timeout_s = 150.0 if default_device(device).type == "cpu" else 90.0
    vad_models, errors = [], []

    def vad_factory(n):
        vad_models.append(default_vad_factory(n, device))
        return vad_models[-1]

    def guard(fn):  # a failure on a worker thread fails the call
        def run(*a, **kw):
            try:
                return fn(*a, **kw)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                raise
        return run

    ring = RTPIngest(vad_factory)
    alloc = RTPPortAllocator()
    stt_drv, tts_drv = EngineDriver(stt_eng, name="stt"), EngineDriver(tts_eng, name="tts")
    names = sorted({ln[0] for ln in lines} | {ln[1] for ln in lines})
    far = {n: RtpFarEnd(n) for n in names}
    eps = {}

    def wire(line):
        spk, lst, s_lang, t_lang, text, seed, expect = line
        d = types.SimpleNamespace(
            speaker=spk, listener=lst, stt_lang=s_lang, tts_lang=t_lang, text=text,
            seed=seed, expect=expect, segments=[], results=[], dropped=[],
            translated=[], said=[], first_s=[], says=0, says_done=0,
            t_say=None, lock=threading.Lock())
        stt_sess = ses.STTSession(stt_eng, keep_context=True)
        tts_sess = ses.TTSSession(tts_eng, tts_tok, bank)
        translator = Translator(s_lang, t_lang, backend=LexiconBackend())
        n2w = NumbersToWords(t_lang)
        speaker_id = bank.rand_id()
        dst = eps[lst]

        @guard
        def soundout(item):
            if isinstance(item, AudioChunk):
                item.track_id = 1  # TTS on the destination leg's track 1, as the app does
                with d.lock:
                    if d.t_say is not None:
                        d.first_s.append(time.monotonic() - d.t_say)
                        d.t_say = None
            dst.soundout(item)

        @guard
        def say_done():
            with d.lock:
                d.says_done += 1

        @guard
        def text_in(res):
            with d.lock:
                d.results.append(res)
            text = res.text.strip()
            if res.no_speech_prob > 0.5 or not text:  # the app's gate
                d.dropped.append(res.text)
                return
            translated = translator.translate(text)
            groups = regroup_sentences(sent_split(n2w(translated)))
            with d.lock:
                d.translated.append(translated)
                d.said.append(groups)
                d.says += 1
                d.t_say = time.monotonic()
            tts_sess.say(ses.TTSRequest(groups, speaker_id=speaker_id, done_cb=say_done))
            tts_drv.kick()

        @guard
        def vad_chunk_in(chunk):
            with d.lock:
                d.segments.append((chunk.ipos, len(chunk.audio)))
            stt_sess.soundin(ses.STTRequest(chunk=chunk, lang=s_lang, mode="translate",
                                            text_cb=text_in))
            stt_drv.kick()

        tts_sess.start(soundout)
        eps[spk].connect(AudioInput(vad_chunk_in=vad_chunk_in))
        return d

    def finished(d):
        with d.lock:
            return (d.segments and len(d.results) == len(d.segments)
                    and d.says_done == d.says and not far[d.speaker].speaking()
                    and time.monotonic() > far[d.speaker].speech_last + 1.5)

    dirs, media = [], {}
    try:
        for t in (ring, stt_drv, tts_drv):
            t.start()
        for n in names:
            eps[n] = RTPEndpoint(ring, RTPParams(far[n].addr, G711Codec), alloc)
        for n in names:
            far[n].start(eps[n].local_addr)
        dirs = [wire(line) for line in lines]
        t_call = time.monotonic()
        for d in dirs:
            spk, lst = far[d.speaker], far[d.listener]
            d.speech_s = len(audio := render_speech(d.text, d.seed)) / 8000
            t0, n_before = time.monotonic(), len(lst.rx_packets)
            spk.speak(audio)
            deadline = t0 + timeout_s
            while not errors and not finished(d):
                check(time.monotonic() < deadline,
                      f"rtp call {d.speaker}->{d.listener}: not done in {timeout_s} s "
                      f"({len(d.segments)} segments, {len(d.results)} results, "
                      f"{d.says_done} of {d.says} says done)")
                time.sleep(0.05)
            time.sleep(0.3)  # the last packets on their way to the listener
            if errors:
                raise errors[0]
            d.t_speech_last = spk.speech_last
            d.t_first_sound = first_sound_at(lst, n_before)
            d.reply_start_s = (None if d.t_first_sound is None
                               else d.t_first_sound - d.t_speech_last)
            d.rx = rx_audio(lst, n_before)
        media = {"call_s": time.monotonic() - t_call,
                 "native_engine": native.available(),
                 "writers": {n: type(ep.writer).__name__ for n, ep in eps.items()},
                 "pacer_stats": {n: ep.writer.stats() for n, ep in eps.items()
                                 if hasattr(ep.writer, "stats")},
                 "far_sent_pkts": {n: f.sent for n, f in far.items()},
                 "far_rx_pkts": {n: len(f.rx_packets) for n, f in far.items()}}
    finally:
        for f in far.values():
            f.close()
        for ep in eps.values():
            ep.shutdown()
        for t in (stt_drv, tts_drv):
            t.stop()
        ring.stop()
    if errors:
        raise errors[0]
    check(not stt_drv.crash_times and not tts_drv.crash_times,
          f"rtp call: engine drivers crashed ({len(stt_drv.crash_times)} stt, "
          f"{len(tts_drv.crash_times)} tts)")
    for t in (ring, ring.vad_worker, stt_drv, tts_drv):
        check(not t.is_alive(), f"rtp call: thread {t.name} did not stop")
    media["vad_models"] = vad_models
    return {"directions": dirs, **media}


def pacer_jitter_share(n_legs: int = 500) -> dict:
    """The native pacer loop pacing ``n_legs`` legs of 2 s from one thread
    (the load of ``tests/test_cpacer.py``'s SLA test): the share of packets
    sent within 2 ms of their schedule."""
    import socket

    from infernos_tpu_torch.audio.codecs import G711Codec
    from infernos_tpu_torch.media import cpacer

    loop = cpacer.NativePacerLoop()
    rsock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rsock.bind(("127.0.0.1", 0))
    rsock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    ssock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    codec = G711Codec()
    t = np.arange(16000) / 8000
    payload = codec.encode((0.4 * np.sin(2 * np.pi * 300 * t)).astype(np.float32))
    try:
        legs = []
        for i in range(n_legs):
            leg = loop.new_leg(codec, ssock.fileno(), ptime_ms=20)
            leg.set_dest(rsock.getsockname())
            legs.append(leg)
        for i, leg in enumerate(legs):  # staggered starts, as calls arrive
            leg._write_bytes(payload)
            if i % 10 == 9:
                time.sleep(0.02)
        time.sleep(2.6)
        stats = [leg.stats() for leg in legs]
        for leg in legs:
            leg.end()
    finally:
        loop.close()
        ssock.close()
        rsock.close()
    total = sum(s["sent_pkts"] for s in stats)
    late = sum(s["jit_le_5ms"] + s["jit_gt_5ms"] for s in stats)
    return {"legs": n_legs, "packets": total, "share_le_2ms": (total - late) / max(total, 1),
            "max_jitter_ms": max(s["jit_max_ns"] for s in stats) / 1e6}


def phase_rtp_call(torch, attn, ts):
    """The tiny-real pair on the card through the port's loaders (fp32) and
    Griffin-Lim, in a two-leg call over RTP (``drive_rtp_call``); checks both
    directions' speech and the kernels and media it went through.  Returns
    the launch counts of its run (the fp32 modes of kernel 1 and 2)."""
    from infernos_tpu_torch.audio import griffinlim as gl
    from infernos_tpu_torch.media import cpacer, native
    from infernos_tpu_torch.utils.platform import card_info

    t0 = time.perf_counter()
    stt_eng, tts_eng, tts_tok, bank = tiny_real_engines()
    check(stt_eng.device.type == "cuda" and tts_eng.device.type == "cuda",
          "rtp call: the tiny-real engines are not on the card")
    check(stt_eng.ecfg.dtype == torch.float32 and tts_eng.ecfg.dtype == torch.float32,
          "rtp call: the tiny-real engines do not serve fp32 on the card")
    check(isinstance(tts_eng.voc_cfg, gl.GriffinLimConfig) and not ts.is_int8(tts_eng.packed),
          "rtp call: the TTS engine is not dense on Griffin-Lim")
    stt_eng.warmup()
    tts_eng.warmup()
    warm_s = time.perf_counter() - t0
    stt_eng.encode_ms.clear()
    tts_eng.tick_ms.clear()
    tts_eng.tick_frames.clear()
    tts_eng._last_dispatch_t = None

    reset_launch_counts()  # the main path starts here
    call = drive_rtp_call(stt_eng, tts_eng, tts_tok, bank)
    torch.cuda.synchronize()
    attn_launches, fp32_steps = path_launches(launch_counts(), "rtp call", fp32=True)

    encodes = len(stt_eng.encode_ms)
    enc_layers = stt_eng.cfg.encoder_layers
    steps_run = sum(n // tts_eng.cfg.reduction_factor for n in tts_eng.tick_frames)
    check(encodes > 0 and attn_launches == enc_layers * encodes,
          f"rtp call: attention kernel launched {attn_launches} times for "
          f"{encodes} encodes, want {enc_layers} each")
    check(fp32_steps == steps_run and fp32_steps > 0,
          f"rtp call: fp32-cache step kernel launched {fp32_steps} times for "
          f"{steps_run} steps")
    check(call["native_engine"] and native.load_error() is None,
          f"rtp call: native media engine not loaded ({native.load_error()})")
    for n, w in call["writers"].items():
        check(w == cpacer.NativeLegWriter.__name__, f"rtp call: leg {n} paced by {w}")
        sent = call["pacer_stats"][n]["sent_pkts"]
        check(sent > 0, f"rtp call: the native pacer sent {sent} packets on leg {n}")

    out = []
    for d in call["directions"]:
        hyp = transcribe(stt_eng, active_region(d.rx), d.tts_lang)
        acc = word_acc(d.expect, hyp)
        out.append({"direction": f"{d.speaker}->{d.listener}",
                    "langs": f"{d.stt_lang}->{d.tts_lang}", "text": d.text,
                    "speech_s": d.speech_s, "segments": d.segments,
                    "stt_text": [r.text for r in d.results], "dropped": d.dropped,
                    "translated": d.translated, "said": d.said,
                    "stt_latency_s": [r.inf_time for r in d.results],
                    "tts_first_chunk_s": d.first_s,
                    "reply_start_s": d.reply_start_s,
                    "heard": hyp, "expected": d.expect, "word_acc": acc,
                    "rx_s": len(d.rx) / 8000})
    # information: the vocoder's device time per tick at the engine's chunk sizes
    B, pre = tts_eng.ecfg.batch_slots, tts_eng.ecfg.pre_frames
    g = torch.Generator(device="cuda").manual_seed(10)
    gl_ms = {}
    for n in sorted(set(tts_eng.ecfg.chunk_schedule)):
        mel = torch.randn((B, pre + n, tts_eng.cfg.num_mel_bins), generator=g,
                          device="cuda") - 3.0
        gl_ms[n] = cuda_ms(lambda: gl.apply(tts_eng.voc_params, tts_eng.voc_cfg, mel), 10)
    vad_model = call["vad_models"][0]
    win = np.zeros((2, 768), np.float32)
    slots = np.arange(2)
    for _ in range(3):
        vad_model(win, slots=slots)
    t0 = time.perf_counter()
    for _ in range(20):
        vad_model(win, slots=slots)
    vad_ms = (time.perf_counter() - t0) / 20 * 1e3
    jitter = pacer_jitter_share()
    emit("rtp_call", card=card_info(), model="tiny-real (fp32, Griffin-Lim)",
         warmup_s=warm_s, call_s=call["call_s"], directions=out,
         word_acc_min=ACC_MIN, attention_fp32_launches=attn_launches,
         fp32_step_launches=fp32_steps, tts_steps_run=steps_run, stt_encodes=encodes,
         encode_ms=stt_eng.encode_ms, tts_ms_per_tick=tts_eng.tick_ms,
         tts_tick_frames=tts_eng.tick_frames, griffinlim_ms_by_frames=gl_ms,
         griffinlim_slots=B, vad_ms_per_forward=vad_ms, vad_batch=2,
         writers=call["writers"], pacer_stats=call["pacer_stats"],
         far_sent_pkts=call["far_sent_pkts"], far_rx_pkts=call["far_rx_pkts"],
         pacer_500_legs=jitter)
    for o in out:
        check(o["word_acc"] >= ACC_MIN,
              f"rtp call {o['direction']}: heard {o['heard']!r}, expected "
              f"{o['expected']!r} (word accuracy {o['word_acc']:.2f} < {ACC_MIN}); "
              f"STT gave {o['stt_text']!r}, translated {o['translated']!r}")
    return attn_launches, fp32_steps


# -- phase 9: the bilingual LiveTranslator call through SIP, in process -------

SIP_CALL_PORTS = {"sip": 25075, "bob": 25085, "rtp": (34500, 34900)}
# a say with both TTS engines stepping one stream vs the same say alone, from
# the same generator state: of the say's peak (one bf16 rounding of slack)
TOGETHER_TOL = 1e-2


def lt_config(sip_port: int, bob_port: int, rtp, metrics_port=None) -> str:
    """The daemon config of the bilingual call (``tests/test_lt_bilingual_e2e.py``):
    inbound calls go to LiveTranslator profile ``c1`` (en <-> pt), which
    dials ``sip/bob`` at ``bob_port``."""
    text = (f"sip:\n  settings:\n    bind: 127.0.0.1:{sip_port}\n  profiles:\n"
            f"    inbound:\n      sink: apps/live_translator/c1\n"
            f"    bob:\n      sip_server: 127.0.0.1:{bob_port}\n"
            f"rtp:\n  settings:\n    min_port: {rtp[0]}\n    max_port: {rtp[1]}\n"
            f"apps:\n  live_translator:\n    profiles:\n      c1:\n"
            f"        stt_langs: ['en', 'pt']\n        tts_langs: ['pt', 'en']\n"
            f"        outbound: sip/bob;cld=900\n")
    if metrics_port:
        text += f"metrics:\n  port: {metrics_port}\n  bind: 127.0.0.1\n"
    return text


class AppEvents(logging.Handler):
    """Counts what an app's sessions log at DEBUG (``LTSession`` and
    ``AIASession`` log each): VAD segments in, STT results (their texts
    kept), LLM replies, and says started and played out.  A say is played
    out when the pacer has sent its last packet (its done marker fires
    there, ``ASMarkerSentDoneCB``)."""

    KINDS = (("vad chunk", "segments"), ("stt ", "results"), ("llm ", "replies"),
             ("say done", "says_done"), ("say ", "says"))

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.counts = {k: 0 for _, k in self.KINDS}
        self.counts["finals"] = 0  # LLM replies' last sentences
        self.stt_texts, self.llm_texts = [], []

    def emit(self, record):
        msg = str(record.msg)
        if "Session %s" not in msg or ": " not in msg:
            return
        what = msg.split(": ", 1)[1]
        for prefix, kind in self.KINDS:
            if what.startswith(prefix):
                self.counts[kind] += 1
                if kind == "results":
                    self.stt_texts.append(record.args[-2])
                elif kind == "replies":
                    self.llm_texts.append(record.args[-2])
                    self.counts["finals"] += bool(record.args[-1])
                return

    def since(self, base: dict) -> dict:
        return {k: v - base[k] for k, v in self.counts.items()}


# a phone's VAD emits a segment within this long after its speech ends
VAD_RELEASE_S = 1.5
# after the reply's says are played out, its last packets are on their way
QUIET_S = 1.0


def says_over(events: AppEvents, base: dict, t_last: float, llm: bool = False) -> bool:
    """Whether a reply is over: ``VAD_RELEASE_S`` after the speaker's last
    speech packet (``t_last``), every segment has its STT result, with
    ``llm`` the LLM's reply has ended, at least one say was started and
    every say started has been played out."""
    n = events.since(base)
    return (time.monotonic() > t_last + VAD_RELEASE_S and n["segments"] >= 1
            and n["results"] == n["segments"] and (not llm or n["finals"] >= 1)
            and n["says"] >= 1 and n["says_done"] == n["says"])


def wait_reply(phone, n_before: int, timeout: float, over) -> bool:
    """Until ``over()`` (the app has played the reply out: :func:`says_over`),
    sound has come in after the first ``n_before`` packets and no packet
    has arrived for ``QUIET_S``; False at ``timeout``.  A quiet stretch
    alone never ends a reply: a TTS tick slower than real time leaves one
    inside it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pkts = phone.rx_packets[n_before:]
        if pkts and time.monotonic() - pkts[-1][0] > QUIET_S and over():
            audio = rx_audio(phone, n_before)
            if len(audio) > 4000 and np.abs(audio).max() > SILENT:
                return True
        time.sleep(0.1)
    return False


def drive_sip_call(device=None, together: bool = False, on_ready=None,
                   stt_actr=None, ports=SIP_CALL_PORTS) -> dict:
    """The bilingual LiveTranslator call through SIP, in process: the YAML
    config is read by ``InfernConfig`` and ``build_cluster`` spawns the
    daemon's actor graph (RTP -> LiveTranslator -> SIP) with the trained
    tiny-real models (``INFERNOS_MODEL_MODE=tiny-real``) on ``device``.
    ``stt_actr`` is an STT actor the app shares instead of starting its
    own: a ``cluster.remote.RemoteActorHandle`` to a started tiny-real
    ``STTActor`` in a peer process that also serves a :class:`PeerProbe`
    named ``PROBE`` (:class:`Peer`); the STT numbers are then the peer's,
    read through the probe.  ``ports``: the app's SIP port, Bob's and the
    RTP range (``SIP_CALL_PORTS``).  A
    ``FakePhone`` (Alice) calls the SIP port; the app dials Bob, a
    ``FarEnd``; each line of ``CALL_LINES`` is spoken in turn by its
    speaker's phone as paced G.711 RTP, and what the listener hears is
    kept until the app has played the reply out (:func:`wait_reply`).  With ``together``, the two TTS actors then say each line's
    expected text at once through their session API (both engines
    stepping one stream).  ``on_ready()`` runs once the cluster is up and
    warm, right before the first call.  Alice hangs up at the end; Bob
    must get the BYE, and ``stop_all()`` must leave no actor thread of the
    call (``actor_threads_left``: those alive that it started).
    Returns, for each direction, the STT texts (the app's debug log), the
    STT results, their mean latency and the TTS first chunk (the engines'
    ``stt.audio_s``, ``stt.inf_time`` and ``tts.ttfb`` over the direction),
    what the listener heard and the reply start; the encodes the STT ran
    during the call; and the engines (``stt`` None when it is remote)."""
    import tempfile

    from infernos_tpu_torch.bench.phone import FakePhone, FarEnd
    from infernos_tpu_torch.cluster.actors import lookup, stop_all
    from infernos_tpu_torch.config import InfernConfig
    from infernos_tpu_torch.main import build_cluster
    from infernos_tpu_torch.utils.metrics import metrics
    from infernos_tpu_torch.utils.metrics_export import render_prometheus
    from infernos_tpu_torch.utils.platform import default_device

    timeout_s = 150.0 if default_device(device).type == "cpu" else 60.0

    def registry() -> dict:  # the process's metrics, named as /metrics names them
        return prom_values(render_prometheus(metrics.snapshot()))

    # where the STT's numbers live: this process, or the peer serving it
    probe = None if stt_actr is None else probe_of(stt_actr)
    stt_registry = registry if probe is None else lambda: probe.ask_sync("registry")

    app_log, events = logging.getLogger("infernos_tpu_torch.apps.lt"), AppEvents()
    app_level = app_log.level
    alice = bob = None
    out = {}
    # actor threads this call did not start (a test process may hold others')
    before = set(threading.enumerate())
    with mock.patch.dict(os.environ, {"INFERNOS_MODEL_MODE": "tiny-real"}):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "lt.yaml")
            with open(path, "w") as f:
                f.write(lt_config(ports["sip"], ports["bob"], ports["rtp"]))
            iconf = InfernConfig(path)
        try:
            app_log.addHandler(events)
            app_log.setLevel(logging.DEBUG)
            t0 = time.perf_counter()
            handles = build_cluster(iconf, tiny=True, bind_ip="127.0.0.1",
                                    stt_actr=stt_actr, device=device)
            out["boot_s"] = time.perf_counter() - t0
            stt = None if probe is not None else lookup("stt:c1")._actor.engine
            tts = {lang: lookup(f"tts:c1:{lang}")._actor.engine for lang in ("pt", "en")}
            if stt is not None:
                stt.encode_ms.clear()
                encodes = lambda: len(stt.encode_ms)
            else:
                encodes = lambda: probe.ask_sync("encodes", stt_actr.name)
            encodes0 = encodes()
            for eng in tts.values():
                eng.tick_ms.clear()
                eng.tick_frames.clear()
            out.update(stt=stt, tts=tts, handles=sorted(handles))
            bob = FarEnd(port=ports["bob"])
            alice = FakePhone()
            if on_ready is not None:
                on_ready()
            t_call = time.monotonic()
            alice.call(iconf.sip_conf.bind)
            check(alice.uac.connected, "sip call: the call was not answered")
            check(bob.answered.wait(20.0), "sip call: the app did not dial Bob")
            phones = {"alice": alice, "bob": bob}
            dirs = []
            for spk, lst, s_lang, t_lang, text, seed, expect in CALL_LINES:
                listener = phones[lst]
                n_before, n_texts, base = len(listener.rx_packets), len(events.stt_texts), registry()
                stt_base = base if probe is None else stt_registry()
                seen = dict(events.counts)
                audio = render_speech(text, seed)
                t_send = time.monotonic()
                if spk == "alice":
                    alice.stream_bg(audio, then_silence=True)
                else:
                    check(bob.last_rtp_src is not None,
                          "sip call: no media reached Bob's leg")
                    bob.stream_bg(audio, bob.last_rtp_src)
                # the last speech packet's send time at the phones' 20 ms pace
                t_last = t_send + (len(audio) // FRAME_BYTES - 1) * 0.020
                heard = wait_reply(listener, n_before, timeout_s,
                                   lambda: says_over(events, seen, t_last))
                phones[spk].stop_streaming()
                check(heard, f"sip call {spk}->{lst}: no reply within {timeout_s} s")
                t_first = first_sound_at(listener, n_before)
                # stt.inf_time is observed by the engine and again by the
                # app, with the same value: its mean is the results' mean
                work = calls_work(base, registry())
                stt_work = work if probe is None else calls_work(stt_base, stt_registry())
                dirs.append(types.SimpleNamespace(
                    speaker=spk, listener=lst, stt_lang=s_lang, tts_lang=t_lang,
                    text=text, expect=expect, speech_s=len(audio) / 8000,
                    stt_text=events.stt_texts[n_texts:],
                    stt_results=stt_work["stt_audio_s"]["count"],
                    stt_latency_s=stt_work["stt_inf_time"]["mean"],
                    says=work["tts_ttfb"]["count"], first_chunk_s=work["tts_ttfb"]["mean"],
                    rx=rx_audio(listener, n_before),
                    reply_start_s=None if t_first is None else t_first - t_last))
            out["call_s"] = time.monotonic() - t_call
            out["directions"] = dirs
            out["stt_encodes"] = encodes() - encodes0
            if together:
                out["together"] = say_together(timeout_s)
            check(bool(bob.stack.dialogs), "sip call: Bob holds no dialog")
            alice.hangup()
            deadline = time.monotonic() + 10.0
            while bob.stack.dialogs and time.monotonic() < deadline:
                time.sleep(0.05)
            out["bob_got_bye"] = not bob.stack.dialogs  # his UAS tore down
        finally:
            for ph in (alice, bob):
                if ph is not None:
                    ph.close()
            stop_all()
            app_log.removeHandler(events)
            app_log.setLevel(app_level)
    time.sleep(0.5)
    out["actor_threads_left"] = [t.name for t in threading.enumerate() if t not in before
                                 and t.name.startswith("actor:") and t.is_alive()]
    return out


def say_together(timeout_s: float) -> list:
    """Each line's expected text said at once by the TTS actor of its
    language (one session each, speaker 0), through the actors' session
    API, then again by each actor alone from the same generator state.  At
    once, both engines' steps go through the step kernel on one stream and
    share its scratch; alone, they do not, so the two runs must give the
    same audio.  Returns each say's audio at 8 kHz, as a phone hears it, in
    both runs."""
    from infernos_tpu_torch.cluster.actors import lookup
    from infernos_tpu_torch.serving import sessions as ses

    says = []
    for *_, t_lang, _text, _seed, expect in CALL_LINES:
        h = lookup(f"tts:c1:{t_lang}")
        says.append(types.SimpleNamespace(lang=t_lang, expect=expect, handle=h,
                                          gen=h._actor.engine._gen))

    def run(group):
        for say in group:
            say.chunks, say.done = [], threading.Event()
            say.sid = say.handle.ask_sync("new_tts_session")

            def soundout(item, say=say):
                if hasattr(item, "on_proc"):  # the say's end marker
                    item.on_proc()
                else:
                    say.chunks.append(item.resample(8000).audio)

            say.handle.ask_sync("tts_session_start", say.sid, soundout)
        t0 = time.monotonic()
        for say in group:  # queued back to back: the engines step together
            say.handle.call("tts_session_say", say.sid,
                            ses.TTSRequest(say.expect, speaker_id=0, done_cb=say.done.set))
        for say in group:
            check(say.done.wait(timeout_s), f"sip call: the {say.lang} say did not end")
            say.handle.ask_sync("tts_session_end", say.sid)
        return time.monotonic() - t0, [np.concatenate(say.chunks) if say.chunks
                                       else np.zeros(0, np.float32) for say in group]

    states = [say.gen.get_state() for say in says]
    t_together, together = run(says)
    alone = []
    for say, state in zip(says, states):
        say.gen.set_state(state)
        alone.append(run([say])[1][0])
    return [{"lang": say.lang, "expect": say.expect, "s": t_together,
             "audio": a, "alone": b} for say, a, b in zip(says, together, alone)]


def phase_sip_call(torch, attn, ts):
    """Phase ``sip_call``: :func:`drive_sip_call` on the card (fp32,
    Griffin-Lim), with both TTS engines saying at once at its end.  Checks
    both directions' speech, the teardown and the kernels the call went
    through; returns the launch counts of its run (the fp32 modes of
    kernels 1 and 2)."""
    from infernos_tpu_torch.audio import griffinlim as gl
    from infernos_tpu_torch.utils.platform import card_info

    # the main path starts at on_ready, the cluster warm
    call = drive_sip_call(together=True, on_ready=reset_launch_counts)
    torch.cuda.synchronize()
    attn_launches, steps_k = path_launches(launch_counts(), "sip call", fp32=True)

    stt, tts = call["stt"], call["tts"]
    check(stt.device.type == "cuda" and stt.ecfg.dtype == torch.float32,
          "sip call: the STT actor does not serve fp32 on the card")
    for lang, eng in tts.items():
        check(eng.device.type == "cuda" and eng.ecfg.dtype == torch.float32
              and isinstance(eng.voc_cfg, gl.GriffinLimConfig) and not ts.is_int8(eng.packed),
              f"sip call: the {lang} TTS actor is not dense fp32 on Griffin-Lim")
    encodes = call["stt_encodes"]
    check(encodes > 0 and attn_launches == stt.cfg.encoder_layers * encodes,
          f"sip call: attention kernel launched {attn_launches} times for "
          f"{encodes} encodes, want {stt.cfg.encoder_layers} each")
    steps = call_checks(call, tts, steps_k, "sip call")
    out = heard_directions(stt, call)
    together = []
    for say in call["together"]:
        a, b = say["audio"], say["alone"]
        hyp = transcribe(stt, active_region(a), say["lang"])
        together.append({"lang": say["lang"], "expected": say["expect"], "heard": hyp,
                         "word_acc": word_acc(say["expect"], hyp), "done_s": say["s"],
                         "samples": [len(a), len(b)],
                         "max_abs_diff_alone": float(np.abs(a - b).max())
                         if len(a) == len(b) and len(a) else None,
                         "peak": float(np.abs(a).max()) if len(a) else 0.0})
    emit("sip_call", card=card_info(), model="tiny-real (fp32, Griffin-Lim)",
         boot_s=call["boot_s"], call_s=call["call_s"], actors=call["handles"],
         directions=out, both_engines_at_once=together, word_acc_min=ACC_MIN,
         attention_fp32_launches=attn_launches, fp32_step_launches=steps_k,
         tts_steps_run=steps, stt_encodes=encodes, encode_ms=stt.encode_ms,
         tts_ms_per_tick={lang: eng.tick_ms for lang, eng in tts.items()},
         bob_got_bye=call["bob_got_bye"])
    check_heard(out, "sip call")
    for o in together:  # the words are information: a say is a sample
        check(o["max_abs_diff_alone"] is not None and o["peak"] > SILENT
              and o["max_abs_diff_alone"] <= TOGETHER_TOL * o["peak"],
              f"sip call: the {o['lang']} say at once differs from the say alone: {o}")
    return attn_launches, steps_k, {o["direction"]: o["reply_start_s"] for o in out}


def call_checks(call, tts, step_launches: int, what: str) -> dict:
    """The checks :func:`drive_sip_call`'s call shares in ``sip_call`` and
    ``remote_call``: both TTS engines stepped, one launch of the step
    kernel's fp32-cache mode per step (the caller's ``path_launches`` holds
    the other modes at 0), Bob got the BYE and no actor thread is left.
    Returns the steps per language."""
    steps = {lang: sum(n // eng.cfg.reduction_factor for n in eng.tick_frames)
             for lang, eng in tts.items()}
    check(all(steps.values()) and step_launches == sum(steps.values()),
          f"{what}: fp32-cache step kernel launched {step_launches} times for "
          f"{steps} steps")
    check(call["bob_got_bye"], f"{what}: Bob did not get the BYE")
    check(not call["actor_threads_left"],
          f"{what}: actor threads left after stop_all: {call['actor_threads_left']}")
    return steps


def heard_directions(stt_eng, call) -> list:
    """Each direction of :func:`drive_sip_call`'s call as the phases print
    it, with what the listener heard transcribed by ``stt_eng`` (stepped
    here) and its word accuracy."""
    out = []
    for d in call["directions"]:
        hyp = transcribe(stt_eng, active_region(d.rx), d.tts_lang)
        out.append({"direction": f"{d.speaker}->{d.listener}",
                    "langs": f"{d.stt_lang}->{d.tts_lang}", "text": d.text,
                    "speech_s": d.speech_s, "stt_text": d.stt_text,
                    "stt_results": d.stt_results, "stt_latency_s": d.stt_latency_s,
                    "says": d.says, "tts_first_chunk_s": d.first_chunk_s,
                    "reply_start_s": d.reply_start_s, "heard": hyp,
                    "expected": d.expect, "word_acc": word_acc(d.expect, hyp),
                    "rx_s": len(d.rx) / 8000})
    return out


def check_heard(out: list, what: str) -> None:
    for o in out:
        check(o["word_acc"] >= ACC_MIN,
              f"{what} {o['direction']}: heard {o['heard']!r}, expected "
              f"{o['expected']!r} (word accuracy {o['word_acc']:.2f} < {ACC_MIN})")


# -- phase 10: the Live Translator with its STT in a peer process -----------------

REMOTE_CALL_PORTS = {"sip": 25079, "bob": 25089, "rtp": (40200, 40600)}
PROBE = "probe"  # the name a peer serves its PeerProbe under
# a peer's first line, then its ActorServer until its stdin closes; a fresh
# interpreter, never a fork (a CUDA context does not survive one)
PEER_SRC = (
    "import json, os, sys, torch\n"
    "from infernos_tpu_torch.cluster import remote\n"
    "srv = remote.ActorServer(('127.0.0.1', 0))\n"
    "cuda = torch.cuda.is_available()\n"
    "print(json.dumps({'port': srv.laddr[1], 'pid': os.getpid(), 'cuda': cuda,\n"
    "                  'count': torch.cuda.device_count(),\n"
    "                  'kind': torch.cuda.get_device_name(0) if cuda else None}),\n"
    "      flush=True)\n"
    "sys.stdin.readline()\n")
# the full-width STT of remote_call: stt_ladder's draw (encoder from
# init_params at seed 5, decoder at HF Whisper's init from seed 6), the
# ckpt_port engine (4 slots, tokens capped as the ramp caps them)
REMOTE_STT_SEEDS = (5, 6)
REMOTE_STT_REQUESTS = (2.0, 3.5, 5.25, 8.0)  # the stt phase's utterances, seconds
REMOTE_STT_TIMEOUT_S = 120.0  # one request through either placement
# no_speech_prob and avg_logprob of the same request, peer against this
# process: both placements run the same kernels on the same card in the
# same batches, and every reading was equal to the last bit (PERF.md §6,
# remote_call)
REMOTE_NS_TOL = 0.0
REMOTE_LOGPROB_TOL = 0.0
# SIGKILL of the peer to the outstanding ask's ConnectionError: the reading
# was 0.136 s (the peer's sockets close as its CUDA context is torn down;
# PERF.md §6, remote_call)
REMOTE_DEAD_S = 1.0
REMOTE_NAP_S = 60.0  # the ask left outstanding when the peer is killed


class Peer:
    """A peer process serving the port's ``cluster.remote.ActorServer`` on
    127.0.0.1 (:data:`PEER_SRC`, run from this checkout with ``env`` added
    to the environment), this process's connection to it (``heartbeat_s``
    as ``remote.connect`` takes it) and the :class:`PeerProbe` it serves as
    :data:`PROBE`.  ``info`` is the peer's first line: its port, pid, whether
    it sees a card, its CUDA device count and the card's name.  ``close``
    ends it."""

    def __init__(self, env=None, heartbeat_s: float = 5.0):
        import subprocess

        from infernos_tpu_torch.cluster import remote

        root = os.path.dirname(os.path.abspath(__file__))
        penv = dict(os.environ, **(env or {}))
        penv["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen([sys.executable, "-c", PEER_SRC], cwd=root,
                                     env=penv, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)
        self.conn = None
        try:
            line = self.proc.stdout.readline()
            check(line.startswith("{"), f"peer: no first line ({line!r})")
            self.info = json.loads(line)
            self.conn = remote.connect(("127.0.0.1", self.info["port"]),
                                       heartbeat_s=heartbeat_s)
            self.probe = self.conn.spawn_remote("chip_smoke:PeerProbe", name=PROBE,
                                                timeout=60.0)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except Exception:
            self.proc.kill()
            self.proc.wait()


def probe_of(handle):
    """The :class:`PeerProbe` of the peer that ``handle`` (a
    ``cluster.remote.RemoteActorHandle``) reaches."""
    from infernos_tpu_torch.cluster import remote

    return remote.RemoteActorHandle(handle._conn, PROBE)


class PeerProbe:
    """The actor a :class:`Peer` serves as :data:`PROBE` (spawned by its path,
    ``chip_smoke:PeerProbe``): what the phases read of the peer's process,
    and the full-width STT actor of ``remote_call`` started there."""

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    def registry(self) -> dict:
        """The peer's metrics, named as ``/metrics`` names them."""
        from infernos_tpu_torch.utils.metrics import metrics
        from infernos_tpu_torch.utils.metrics_export import render_prometheus

        return prom_values(render_prometheus(metrics.snapshot()))

    def launches(self, zero: bool = False) -> dict:
        """Every kernel mode's launches in the peer (``ops.launch_counts``),
        set to 0 after the read with ``zero``."""
        n = launch_counts()
        if zero:
            reset_launch_counts()
        return n

    def encodes(self, name: str) -> int:
        """The encodes the engine of the peer's STT actor ``name`` has run."""
        from infernos_tpu_torch.cluster.actors import lookup

        return len(lookup(name)._actor.engine.encode_ms)

    def modules(self) -> list:
        """The ``jax``, reference and ``transformers`` modules the peer has
        loaded."""
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "infernos_tpu", "transformers"))

    def start_full_stt(self, name: str) -> str:
        """:func:`full_stt_actor` in the peer; returns the actor's name."""
        return full_stt_actor(name).name

    def warm_resample(self) -> None:
        """The peer's first 8 to 16 kHz resample (what an STT session does
        to a phone's chunk): it imports ``scipy.signal`` and plans the
        filter, 2.6 s on an H100 machine's host (PERF.md §6), which this
        process has paid before its calls."""
        from infernos_tpu_torch.audio.chunk import AudioChunk

        AudioChunk(np.zeros(160, np.float32), 8000).resample(16000)

    def nap(self, seconds: float) -> str:
        time.sleep(seconds)
        return "rested"


def full_stt_actor(name: str):
    """An ``STTActor`` at Whisper large-v3 width on the card, spawned and
    started in this process as ``name`` on :data:`REMOTE_STT_SEEDS`' draw
    (the same in every process on the card), in bf16, with
    ``ckpt_setup``'s engine (4 slots, tokens capped as the ramp caps them);
    started without ``INFERNOS_MODEL_MODE``, which would serve tiny-real."""
    import torch

    from infernos_tpu_torch.cluster.actors import spawn
    from infernos_tpu_torch.cluster.model_actors import STTActor
    from infernos_tpu_torch.models import presets
    from infernos_tpu_torch.models import whisper as wsp

    enc_seed, dec_seed = REMOTE_STT_SEEDS
    cfg = presets.WHISPER_LARGE_V3
    params = wsp.init_params(cfg, torch.Generator(device="cuda").manual_seed(enc_seed),
                             "cuda", torch.bfloat16)
    params.update(hf_init_decoder(torch, params,
                                  torch.Generator(device="cuda").manual_seed(dec_seed)))
    h = spawn(STTActor, tiny=False, params=params, ecfg=ckpt_setup(torch).stt, name=name)
    with mock.patch.dict(os.environ):
        os.environ.pop("INFERNOS_MODEL_MODE", None)
        h.ask_sync("start", timeout=600.0)
    return h


def serve_utterances(handle, audios, timeout: float = REMOTE_STT_TIMEOUT_S):
    """Each of ``audios`` (16 kHz) through one STT session of ``handle``
    (``new_stt_session``, ``stt_session_soundin``, ``stt_session_end``),
    each sent after the last came back, so that every placement batches
    them alike.  Returns the results and each one's seconds from the send
    to its ``text_cb`` here."""
    from infernos_tpu_torch.audio.chunk import AudioChunk
    from infernos_tpu_torch.serving.sessions import STTRequest

    sid = handle.ask_sync("new_stt_session")
    results, latency = [], []
    for i, a in enumerate(audios):
        got, done = [], threading.Event()

        def text_cb(res, got=got, done=done):
            got.append((time.perf_counter(), res))
            done.set()

        t0 = time.perf_counter()
        handle.call("stt_session_soundin", sid, STTRequest(
            chunk=AudioChunk(a, 16000), text_cb=text_cb, lang="en", mode="transcribe"))
        check(done.wait(timeout), f"remote call: request {i} got no result within {timeout} s")
        latency.append(got[0][0] - t0)
        results.append(got[0][1])
    handle.ask_sync("stt_session_end", sid)
    return results, latency


def phase_remote_call(torch, attn, ts, sip_reply=None):
    """Phase ``remote_call``: the STT served from a second process on the
    card through the multi-host plane (``cluster/remote.py``).

    A :class:`Peer` (``INFERNOS_MODEL_MODE=tiny-real`` in its environment)
    must see the card and load no ``jax`` or reference module.  Full width:
    its probe starts :func:`full_stt_actor` there, and this process starts
    the same; the ``stt`` phase's four utterances go through each
    (:func:`serve_utterances`, every ``text_cb`` crossing back over the
    socket from the peer), and the tokens must be equal, more than one
    distinct in each decode, and ``no_speech_prob`` and ``avg_logprob``
    within :data:`REMOTE_NS_TOL` and :data:`REMOTE_LOGPROB_TOL`; kernel 1
    launches 32 times per encode in the peer.  The call: a tiny-real
    ``STTActor`` in the peer is the ``stt_actr`` of :func:`drive_sip_call`
    (the bilingual call through SIP, the TTS actors here): both directions
    must reach 0.6 word accuracy (heard by a tiny-real STT engine here);
    kernel 1 launches once per encoder layer and encode in the peer and
    not here, kernel 2 once per step here.  Death: the peer gets SIGKILL with
    an ask outstanding, which must fail with ``ConnectionError`` within
    :data:`REMOTE_DEAD_S`; a new call on the STT handle must raise at once
    and ``stop_all()`` leave no actor thread.  ``sip_reply`` is the
    ``sip_call`` phase's reply start per direction, printed beside this
    call's.  Returns the launches of kernel 1 in the peer (the full-width
    requests', bf16, and the call's, fp32) and of kernel 2 here (the
    call's, over fp32 caches)."""
    from infernos_tpu_torch.cluster import remote
    from infernos_tpu_torch.cluster.actors import stop_all
    from infernos_tpu_torch.models import presets, tiny_real
    from infernos_tpu_torch.serving import stt_engine as stt
    from infernos_tpu_torch.utils.platform import card_info

    t_phase = time.perf_counter()
    out = {"card": card_info()}
    t0 = time.perf_counter()
    peer = Peer({"INFERNOS_MODEL_MODE": "tiny-real"})
    try:
        out["peer"] = peer.info
        out["peer_start_s"] = time.perf_counter() - t0
        check(peer.info["cuda"] and peer.info["count"] >= 1,
              f"remote call: the peer sees no card: {peer.info}")
        loaded = peer.probe.ask_sync("modules")
        check(not loaded, f"remote call: the peer loaded {loaded}")

        # full width: the same draw served from the peer and from here
        rng = np.random.default_rng(0)
        audios = [synth_audio(rng, s) for s in REMOTE_STT_REQUESTS]
        t0 = time.perf_counter()
        far = remote.RemoteActorHandle(
            peer.conn, peer.probe.ask_sync("start_full_stt", "stt:full", timeout=900.0))
        out["full_start_peer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        near = full_stt_actor("stt:full:here")
        out["full_start_here_s"] = time.perf_counter() - t0
        enc0 = peer.probe.ask_sync("encodes", far.name)
        peer.probe.ask_sync("launches", True)  # the remote path starts here
        far_res, far_lat = serve_utterances(far, audios)
        full_attn = path_launches(peer.probe.ask_sync("launches"), "remote call full width",
                                  fp32=False)[0]
        full_encodes = peer.probe.ask_sync("encodes", far.name) - enc0
        near_res, near_lat = serve_utterances(near, audios)
        near.stop()
        far.stop()
        del near
        torch.cuda.empty_cache()
        reqs = []
        for i, (a, f, n) in enumerate(zip(audios, far_res, near_res)):
            reqs.append({"audio_s": len(a) / 16000, "tokens": list(f.tokens),
                         "tokens_here": list(n.tokens), "distinct": len(set(f.tokens)),
                         "no_speech_prob": [f.no_speech_prob, n.no_speech_prob],
                         "avg_logprob": [f.avg_logprob, n.avg_logprob],
                         "ns_abs_diff": abs(f.no_speech_prob - n.no_speech_prob),
                         "logprob_abs_diff": abs(f.avg_logprob - n.avg_logprob),
                         "latency_s": [far_lat[i], near_lat[i]],
                         "latency_added_s": far_lat[i] - near_lat[i],
                         "inf_time_s": [f.inf_time, n.inf_time],
                         "wire_s": [far_lat[i] - f.inf_time, near_lat[i] - n.inf_time]})
        out["full_width"] = {"model": "whisper-large-v3 (stt_ladder draw, bf16)",
                             "requests": reqs, "encodes": full_encodes,
                             "attention_launches": full_attn}
        emit("remote_call_full", **out)

        # the call: the tiny-real STT in the peer, everything else here
        t0 = time.perf_counter()
        far = peer.conn.spawn_remote("infernos_tpu_torch.cluster.model_actors:STTActor",
                                     True, name="stt:peer", timeout=60.0)
        far.ask_sync("start", timeout=600.0)
        out["tiny_start_peer_s"] = time.perf_counter() - t0
        peer.probe.ask_sync("warm_resample")
        enc0 = peer.probe.ask_sync("encodes", far.name)

        def zero_counts():  # the main path starts here, the cluster warm
            reset_launch_counts()
            peer.probe.ask_sync("launches", True)

        call = drive_sip_call(on_ready=zero_counts, stt_actr=far, ports=REMOTE_CALL_PORTS)
        torch.cuda.synchronize()
        here_attn, steps_k = path_launches(launch_counts(), "remote call", fp32=True)
        call_attn, peer_steps = path_launches(peer.probe.ask_sync("launches"),
                                              "remote call peer", fp32=True)
        encodes = peer.probe.ask_sync("encodes", far.name) - enc0
        check(call["stt"] is None and call["stt_encodes"] == encodes,
              "remote call: the STT did not run in the peer")
        sp, scfg, stok, secfg = tiny_real.load_tiny_stt("cuda")
        check(encodes > 0 and call_attn == scfg.encoder_layers * encodes and here_attn == 0
              and peer_steps == 0,
              f"remote call: attention kernel launched {call_attn} times in the peer "
              f"and {here_attn} here for {encodes} encodes in the peer, want "
              f"{scfg.encoder_layers} each; {peer_steps} step launches in the peer")
        tts = call["tts"]
        steps = call_checks(call, tts, steps_k, "remote call")
        heard_by = stt.STTEngine(sp, scfg, secfg, detokenize=stok.detokenize)
        dirs = heard_directions(heard_by, call)
        for d in dirs:
            d["sip_call_reply_start_s"] = (sip_reply or {}).get(d["direction"])

        # death: SIGKILL with an ask outstanding
        nap = peer.probe.ask("nap", REMOTE_NAP_S)
        t0 = time.monotonic()
        peer.proc.kill()  # SIGKILL
        try:
            nap.result(timeout=REMOTE_NAP_S)
            err = None
        except Exception as e:
            err = e
        dead_s = time.monotonic() - t0
        t0 = time.monotonic()
        try:
            far.call("stt_session_end", None)
            call_err = None
        except Exception as e:
            call_err = e
        call_raise_s = time.monotonic() - t0
        peer.proc.wait(timeout=30)
        stop_all()
        time.sleep(0.5)
        left = [t.name for t in threading.enumerate()
                if t.name.startswith("actor:") and t.is_alive()]
    finally:
        peer.close()
    emit("remote_call", card=out["card"], peer=out["peer"], model="tiny-real (fp32, Griffin-Lim)",
         peer_start_s=out["peer_start_s"], tiny_start_peer_s=out["tiny_start_peer_s"],
         boot_s=call["boot_s"], call_s=call["call_s"], directions=dirs,
         word_acc_min=ACC_MIN, peer_attention_fp32_launches=call_attn,
         here_attention_launches=here_attn, fp32_step_launches=steps_k,
         tts_steps_run=steps, stt_encodes_in_peer=encodes,
         full_width_attention_launches=full_attn,
         death={"error": repr(err), "seconds": dead_s, "bound_s": REMOTE_DEAD_S,
                "call_after": repr(call_err), "call_raise_s": call_raise_s,
                "actor_threads_left": left},
         phase_s=time.perf_counter() - t_phase)
    for i, r in enumerate(reqs):
        check(r["tokens"] == r["tokens_here"],
              f"remote call: request {i} tokens {r['tokens']} from the peer, "
              f"{r['tokens_here']} here")
        check(r["distinct"] > 1, f"remote call: request {i} decodes one token: {r['tokens']}")
        check(r["ns_abs_diff"] <= REMOTE_NS_TOL and r["logprob_abs_diff"] <= REMOTE_LOGPROB_TOL,
              f"remote call: request {i} no_speech_prob / avg_logprob differ: {r}")
    layers = presets.WHISPER_LARGE_V3.encoder_layers
    check(full_encodes == len(audios) and full_attn == layers * full_encodes,
          f"remote call: kernel 1 launched {full_attn} times in the peer for "
          f"{full_encodes} encodes, want {layers} each")
    check_heard(dirs, "remote call")
    check(isinstance(err, ConnectionError) and dead_s <= REMOTE_DEAD_S,
          f"remote call: the outstanding ask gave {err!r} {dead_s:.3f} s after SIGKILL, "
          f"want ConnectionError within {REMOTE_DEAD_S} s")
    check(isinstance(call_err, ConnectionError) and call_raise_s < 0.1,
          f"remote call: a call on the dead link gave {call_err!r} in {call_raise_s:.3f} s")
    check(not left, f"remote call: actor threads left after stop_all: {left}")
    return full_attn, call_attn, steps_k


# -- phase 11: the daemon at full width through its entry point -----------------

DAEMON_PORTS = {"sip": 25271, "bob": 25281, "metrics": 25291, "rtp": (36500, 36900)}
DAEMON_BOOT_S = 600.0  # the daemon's own bound to answer OPTIONS and /metrics
DAEMON_STOP_S = 30.0  # SIGTERM to exit
DAEMON_SAYINGS = ((("please help now", 21), ("want help today", 22)),
                  (("please help now", 23), ("want help today", 24)))
# runs the daemon's __main__ as ``python -m`` does; on SIGUSR2 it writes the
# kernels' launch counts and the engines' encodes and steps so far to the
# file named in the env (the daemon itself takes SIGUSR1 for a metrics dump)
DAEMON_PRELUDE = """
import json, os, runpy, signal
from infernos_tpu_torch.cluster import actors
from infernos_tpu_torch.ops import launch_counts, reset_launch_counts


def engines(prefix):
    with actors._registry_lock:
        return [h._actor.engine for n, h in actors._registry.items() if n.startswith(prefix)]


def report(*_):
    stt = engines("stt:")[0]
    tiers = (stt.short, stt.long)
    tts = engines("tts:")
    work = {**launch_counts(),
            "encoder_layers": tiers[0].cfg.encoder_layers,
            "encodes": sum(len(e.encode_ms) for e in tiers),
            "steps": sum(n // e.cfg.reduction_factor for e in tts for n in list(e.tick_frames)),
            "tts_rate": tts[0].ecfg.sample_rate}
    path = os.environ["CHIP_SMOKE_WORK"]
    with open(path + ".tmp", "w") as f:
        json.dump(work, f)
    os.replace(path + ".tmp", path)


reset_launch_counts()
signal.signal(signal.SIGUSR2, report)
runpy.run_module("infernos_tpu_torch", run_name="__main__", alter_sys=True)
"""


def prom_values(text: str) -> dict:
    """Prometheus text, as ``render_prometheus`` writes it, as ``{name: value}``."""
    return {k: float(v) for k, v in (ln.split() for ln in text.splitlines() if ln)}


def scrape_metrics(port: int) -> dict:
    """``/metrics`` of the daemon as ``{name: value}``."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
        return prom_values(r.read().decode())


def calls_work(base: dict, now: dict) -> dict:
    """What the calls added to the metrics since ``base`` (a snapshot taken
    before them): for each observation, how many and their mean (from the
    running count and mean); for each counter, how much."""
    out = {}
    for name in ("stt_inf_time", "stt_audio_s", "tts_session_s", "tts_ttfb",
                 "tts_queue_wait", "llm_gen_time"):
        c0, c1 = (d.get(f"infernos_{name}_count", 0.0) for d in (base, now))
        t0, t1 = (d.get(f"infernos_{name}_mean", 0.0) * c for d, c in ((base, c0), (now, c1)))
        out[name] = {"count": c1 - c0, "mean": (t1 - t0) / (c1 - c0) if c1 > c0 else None}
    for name in ("tts_audio_samples", "driver_crashes", "stt_poisoned_requests",
                 "tts_poisoned_sessions", "llm_tokens", "llm_poisoned_requests"):
        out[name] = now.get(f"infernos_{name}", 0.0) - base.get(f"infernos_{name}", 0.0)
    return out


def pacing(times) -> dict:
    """Packets, span and inter-arrival percentiles (ms) of arrival ``times``."""
    gaps = np.diff(np.asarray(times)) * 1e3
    return {"packets": len(times),
            "span_s": float(times[-1] - times[0]) if len(times) > 1 else 0.0,
            "gap_ms_p50": float(np.percentile(gaps, 50)) if gaps.size else None,
            "gap_ms_p95": float(np.percentile(gaps, 95)) if gaps.size else None}


def daemon_work(proc, path: str, timeout: float = 10.0) -> dict:
    """The daemon's kernel launches and its engines' encodes and steps so
    far: ``DAEMON_PRELUDE`` writes them to ``path`` on SIGUSR2."""
    import signal

    with contextlib.suppress(FileNotFoundError):
        os.remove(path)
    proc.send_signal(signal.SIGUSR2)
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        check(proc.poll() is None, f"daemon exited on SIGUSR2 ({proc.returncode})")
        check(time.monotonic() < deadline, f"daemon did not report its work in {timeout} s")
        time.sleep(0.05)
    with open(path) as f:
        return json.load(f)


@contextlib.contextmanager
def daemon(cfg_text: str, sip_port: int, metrics_port: int):
    """``python -m infernos_tpu_torch -f cfg.yaml`` (config ``cfg_text``)
    in a subprocess under ``DAEMON_PRELUDE``, with ``INFERNOS_STT_MAX_NEW=16``
    and no tiny or CPU mode; yields once SIP answers OPTIONS (the SIP
    actor's start) and ``/metrics`` answers (served once every app and model
    actor has started), at most ``DAEMON_BOOT_S`` after the start.  The
    namespace it yields holds ``proc``, ``work_path`` (for
    :func:`daemon_work`), ``base`` (the metrics before any call), ``boot_s``,
    ``terminate()`` (SIGTERM, then -> exit code or None after
    ``DAEMON_STOP_S``, and seconds), ``closers`` (called at the end) and
    ``ok``: unless the caller sets it, the daemon's log is printed.  The
    daemon is killed if it is still running at the end."""
    import subprocess
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_daemon_")
    cfg, logf = os.path.join(tmp, "cfg.yaml"), os.path.join(tmp, "daemon.log")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    d = types.SimpleNamespace(proc=None, work_path=os.path.join(tmp, "work.json"),
                              ok=False, closers=[])
    env = {k: v for k, v in os.environ.items()
           if k not in ("INFERNOS_MODEL_MODE", "INFERNOS_DEVICE", "INFERNOS_TINY")}
    env.update(INFERNOS_STT_MAX_NEW="16", CHIP_SMOKE_WORK=d.work_path)
    root = os.path.dirname(os.path.abspath(__file__))

    def terminate():
        d.proc.send_signal(15)
        t_term = time.monotonic()
        try:
            rc = d.proc.wait(timeout=DAEMON_STOP_S)
        except subprocess.TimeoutExpired:
            rc = None
        return rc, time.monotonic() - t_term

    d.terminate = terminate
    try:
        with open(logf, "w") as sink:
            d.proc = subprocess.Popen([sys.executable, "-c", DAEMON_PRELUDE, "-f", cfg],
                                      cwd=root, env=env, stdout=sink,
                                      stderr=subprocess.STDOUT)
        t0 = time.monotonic()
        d.base = None
        while d.base is None:
            check(d.proc.poll() is None, f"daemon exited during boot ({d.proc.returncode})")
            check(time.monotonic() - t0 < DAEMON_BOOT_S,
                  f"daemon did not answer OPTIONS and /metrics within {DAEMON_BOOT_S} s")
            time.sleep(1.0)
            if sip_options(("127.0.0.1", sip_port), timeout=1.0) == 200:
                with contextlib.suppress(OSError):
                    d.base = scrape_metrics(metrics_port)
        d.boot_s = time.monotonic() - t0
        yield d
    finally:
        for close in d.closers:
            close()
        if d.proc is not None and d.proc.poll() is None:
            d.proc.kill()
            d.proc.wait()
        if not d.ok and os.path.exists(logf):
            with open(logf) as f:
                print("---- daemon log ----\n" + f.read()[-20000:], file=sys.stderr, flush=True)


def phase_daemon(torch):
    """Phase ``daemon``: ``python -m infernos_tpu_torch -f cfg.yaml`` in a
    subprocess at full width (Whisper-large-v3 in the tiered engine, two
    SpeechT5 + HiFi-GAN + AmendNet engines, bf16, zero weights as the actors
    start without a checkpoint, ``INFERNOS_STT_MAX_NEW=16``), answering two
    concurrent calls, each bridged to one ``FarEnd``, two utterances on
    each inbound leg.  Checks the answer and bridge; the calls' STT and TTS
    work on ``/metrics`` (counted from a scrape after the warm-ups): a
    result per spoken segment, a finished say per call, no driver crash or
    quarantined work; paced RTP to both far ends of each call, Bob's legs
    carrying the audio the TTS engines emitted; exit 0 within 30 s of
    SIGTERM; and the kernels the calls went through, counted apart from
    the warm-ups': kernel 1 launched once per encoder layer per encode,
    kernel 2 (bf16) once per TTS step, int8 never.  Prints the daemon's log
    on a failure.  Returns the calls' launch counts (attention, bf16 step)."""
    from infernos_tpu_torch.bench.phone import FakePhone, FarEnd
    from infernos_tpu_torch.utils.platform import card_info

    class Bob(FarEnd):
        """The B-leg far end of both calls; keeps arrivals by source."""

        def __init__(self, port):
            self.by_src = {}
            super().__init__(port=port)

        def _rtp_in(self, data, addr, rtime):
            super()._rtp_in(data, addr, rtime)
            self.by_src.setdefault(tuple(addr), []).append(time.monotonic())

    p = DAEMON_PORTS
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    with daemon(lt_config(p["sip"], p["bob"], p["rtp"], metrics_port=p["metrics"]),
                p["sip"], p["metrics"]) as d:
        proc, work_path, base, boot_s = d.proc, d.work_path, d.base, d.boot_s
        warm = daemon_work(proc, work_path)  # the warm-ups' launches
        bob = Bob(p["bob"])
        phones = [FakePhone() for _ in DAEMON_SAYINGS]
        d.closers += [bob.close] + [ph.close for ph in phones]
        answered = [None] * len(phones)

        def dial(i):
            answered[i] = phones[i].call(("127.0.0.1", p["sip"]), timeout=60.0)

        dials = [threading.Thread(target=dial, args=(i,)) for i in range(len(phones))]
        t_call = time.monotonic()
        for t in dials:
            t.start()
        for t in dials:
            t.join(90.0)
        check(all(a is not None for a in answered) and all(ph.uac.connected for ph in phones),
              "daemon: a call was not answered")
        deadline = time.monotonic() + 30.0
        while bob.n_answered < len(phones) and time.monotonic() < deadline:
            time.sleep(0.1)
        check(bob.n_answered == len(phones),
              f"daemon: {bob.n_answered} of {len(phones)} calls bridged to Bob")
        gap = np.zeros(16000, np.float32)  # 2 s between the utterances
        for ph, sayings in zip(phones, DAEMON_SAYINGS):
            ph.stream_bg(np.concatenate([render_speech(t, s) if i == 0 else
                                         np.concatenate([gap, render_speech(t, s)])
                                         for i, (t, s) in enumerate(sayings)]))
        segments = sum(len(s) for s in DAEMON_SAYINGS)
        deadline = time.monotonic() + 300.0
        while True:  # stt.audio_s: once per result (stt.inf_time: twice)
            m = scrape_metrics(p["metrics"])
            new = calls_work(base, m)
            if (new["stt_audio_s"]["count"] >= segments
                    and new["tts_session_s"]["count"] >= len(phones)):
                break
            check(proc.poll() is None, "daemon exited during the calls")
            check(time.monotonic() < deadline,
                  f"daemon: the calls' STT/TTS work did not show on /metrics in 300 s: {new}")
            time.sleep(1.0)
        # playout: until Bob's legs have been quiet for 2 s (at most 60 s)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and (
                not bob.by_src or time.monotonic() - max(
                    ts_[-1] for ts_ in bob.by_src.values()) < 2.0):
            time.sleep(0.2)
        call_s = time.monotonic() - t_call
        m = scrape_metrics(p["metrics"])
        new = calls_work(base, m)
        done = daemon_work(proc, work_path)
        calls = {k: done[k] - warm[k] for k in
                 ("attention", "bf16_step", "int8_step", "encodes", "steps")}
        legs = {"bob": {f"{a[0]}:{a[1]}": pacing(v) for a, v in bob.by_src.items()},
                "alice": [pacing([t for t, _ in ph.rx_packets]) for ph in phones]}
        for ph in phones:
            ph.stop_streaming()
            ph.hangup()
        rc, stop_s = d.terminate()
        # the packets the engines' audio fills: at 8 kHz, 160 samples each
        tts_pkts = new["tts_audio_samples"] * 8000 / done["tts_rate"] / FRAME_BYTES
        says = new["tts_session_s"]["count"]
        emit("daemon", card=card_info(), model="whisper-large-v3 (tiered) + 2 x SpeechT5 "
             "+ HiFi-GAN + AmendNet, bf16, zero weights",
             boot_s=boot_s, calls=len(phones), call_s=call_s, legs=legs,
             calls_work=new, metrics={k: v for k, v in m.items() if k.startswith(
                 ("infernos_stt", "infernos_tts", "infernos_driver"))},
             tts_packets=tts_pkts, exit_code=rc, stop_s=stop_s,
             launches={"warm_up": {k: warm[k] for k in calls}, "calls": calls})
        check(rc == 0, f"daemon: exit code {rc} after SIGTERM (want 0 within {DAEMON_STOP_S} s)")
        check(m.get("infernos_driver_crashes", 0) == 0, "daemon: an engine driver crashed")
        check(new["stt_poisoned_requests"] == 0 and new["tts_poisoned_sessions"] == 0,
              f"daemon: quarantined work during the calls: {new}")
        check(new["stt_audio_s"]["count"] >= segments and says >= len(phones),
              f"daemon: the calls' STT results or says fell short: {new}")
        check(len(legs["bob"]) == len(phones), f"daemon: Bob heard {len(legs['bob'])} legs")
        for who, pc in [("bob " + k, v) for k, v in legs["bob"].items()] + \
                [(f"alice {i}", v) for i, v in enumerate(legs["alice"])]:
            check(pc["packets"] >= 10 and 15.0 <= pc["gap_ms_p50"] <= 25.0,
                  f"daemon: {who} did not receive paced RTP: {pc}")
        # Bob hears every say (Alice's speech in Portuguese; Bob says
        # nothing): his legs carry the engines' audio, up to a frame of
        # padding per say each way, and each leg at least one say's worth
        bob_pkts = [pc["packets"] for pc in legs["bob"].values()]
        check(abs(sum(bob_pkts) - tts_pkts) <= 2 * says
              and min(bob_pkts) >= tts_pkts / says - 2,
              f"daemon: Bob's legs got {bob_pkts} packets for the {tts_pkts} "
              f"that {says} says filled")
        check(1 <= calls["encodes"] <= new["stt_audio_s"]["count"]
              and calls["attention"] == done["encoder_layers"] * calls["encodes"],
              f"daemon: attention kernel launched {calls['attention']} times for "
              f"{calls['encodes']} encodes in the calls, want {done['encoder_layers']} each")
        check(calls["steps"] > 0 and calls["bf16_step"] == calls["steps"],
              f"daemon: bf16 step kernel launched {calls['bf16_step']} times for "
              f"{calls['steps']} steps in the calls")
        path_launches(done, "daemon", fp32=False)  # full width: the bf16 modes alone
        d.ok = True
    return calls["attention"], calls["bf16_step"]


# -- phase 12: the LLM engine at Qwen2.5-7B width, int8 weights; phase 13 -----

LLM_SEED = 0
# (prompt bucket, characters of user text): four chat requests, one short
# and one per bucket of the actor's full engine config; ByteTokenizer ids
# are bytes, so a templated prompt is its user text's length plus 88
LLM_REQUESTS = ((128, 5), (128, 36), (256, 150), (512, 400))
LLM_TIMED = 5  # dispatches timed on the card
# tokens per request (the actor's engine allows 256; random weights never
# stop): a depth cut to fit the script's time, the batching check unchanged
LLM_NEW = 64


def llm_prompt(rng, n_chars: int) -> str:
    """A ChatML prompt (system + user) whose user text is ``n_chars`` of
    lowercase words drawn from ``rng``."""
    from infernos_tpu_torch.serving.llm_engine import apply_chat_template

    words = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append("".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(rng.integers(2, 8)))))
    return apply_chat_template([{"role": "system", "content": "be brief"},
                                {"role": "user", "content": " ".join(words)[:n_chars]}])


def run_requests(eng, prompts, tok, max_new=None) -> dict:
    """``prompts`` submitted together to ``eng`` (each for ``max_new``
    tokens, or the engine's own budget) and stepped to the end: each
    request's token ids and its seconds from submit to final, the
    dispatches, the wall seconds and the tokens emitted."""
    from infernos_tpu_torch.serving.llm_engine import LLMRequest

    t_end = [None] * len(prompts)
    t0 = time.perf_counter()
    reqs = [LLMRequest(tok(p), lambda s, fin, i=i: fin and t_end.__setitem__(
        i, time.perf_counter()), max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    streams, steps = {}, 0
    while True:
        for s in eng.slots:
            if s is not None:
                streams[id(s.req)] = s.streamer.tokens
        if not eng.step():
            break
        steps += 1
    wall = time.perf_counter() - t0
    tokens = [list(streams.get(id(r), [])) for r in reqs]
    return {"tokens": tokens, "gen_s": [t - t0 for t in t_end], "dispatches": steps,
            "wall_s": wall, "emitted": sum(len(t) for t in tokens)}


def n_weights(tree) -> int:
    """Elements of the linear weights (dense ``w`` or int8 ``w_q``) of a tree."""
    if isinstance(tree, dict):
        return sum(v.numel() if k in ("w", "w_q") and not isinstance(v, dict)
                   else n_weights(v) for k, v in tree.items())
    return 0


def seeded_layers(torch, params, seed: int) -> None:
    """Fill the layers of ``qwen_int8_init``'s tree in place from a generator
    seeded with ``seed`` on their device: int8 codes uniform in [-127, 127]
    at a scale that makes each weight's deviation 0.02 (dense weights, which
    only tiny dims leave, ``N(0, 0.02)``), and norms of ones.  Zero layers
    add nothing to the residual stream, so each token would depend on the
    previous one alone; these carry terms across positions, heads and the
    cache, which a slot's neighbours must not touch."""
    g = torch.Generator(device=params["embed"]["w"].device).manual_seed(seed)
    for node in params["layers"].values():
        if "w_q" in node:
            node["w_q"].random_(-127, 128, generator=g)
            node["scale"].fill_(0.02 * 3 ** 0.5 / 127)
        elif "w" in node:
            node["w"].normal_(0.0, 0.02, generator=g)
        elif "g" in node:
            node["g"].fill_(1.0)


def phase_llm(torch):
    """Phase ``llm``: the LLM engine as the full ``LLMActor`` starts it --
    Qwen2.5-7B dims in the int8 layout made on the card (``qwen_int8_init``:
    no dense copy), bf16, the actor's engine (``LLM_FULL_ENGINE``: 4 slots,
    buckets 128/256/512, 1024 tokens) -- serving four chat requests at once,
    ``LLM_NEW`` tokens each.
    The actor's zero layers are filled from a seed here
    (:func:`seeded_layers`).  Checks each request's token ids equal a run of
    that request alone (batching invariance) and that the phase's peak
    memory stays under the size of the dense bf16 weights.  Prints the prefill ms per bucket,
    the decode ms per dispatch, per step and per token, tokens/s, the
    ``llm.gen_time`` observations and the peak memory, beside the bound of a
    decode step (its weights and cache rows read once at 3.35 TB/s)."""
    import dataclasses
    import gc

    from torch._subclasses.fake_tensor import FakeTensorMode

    from infernos_tpu_torch.cluster.model_actors import LLM_FULL_ENGINE, qwen_int8_init
    from infernos_tpu_torch.models import presets, qwen, quant
    from infernos_tpu_torch.models.tokenizers import ByteTokenizer
    from infernos_tpu_torch.serving.llm_engine import LLMEngine
    from infernos_tpu_torch.utils.metrics import metrics
    from infernos_tpu_torch.utils.platform import card_info

    cfg = presets.QWEN25_7B
    ecfg = dataclasses.replace(LLM_FULL_ENGINE, dtype=torch.bfloat16)
    with FakeTensorMode():
        dense_bytes = quant.quantized_bytes(qwen.init_params(
            cfg, torch.Generator(), "cpu", torch.bfloat16))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = qwen_int8_init(cfg, torch.device("cuda"), torch.bfloat16, LLM_SEED)
    seeded_layers(torch, params, LLM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    q_bytes = quant.quantized_bytes(params)
    tok = ByteTokenizer()
    eng = LLMEngine(params, cfg, ecfg, detokenize=tok.detokenize, device="cuda")
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(LLM_SEED)
    prompts = [llm_prompt(rng, n) for _, n in LLM_REQUESTS]
    plens = [len(tok(p)) for p in prompts]
    buckets = [next(b for b in ecfg.prompt_buckets if n <= b) for n in plens]
    check(buckets == [b for b, _ in LLM_REQUESTS], f"llm: prompts of {plens} tokens "
          f"fall in buckets {buckets}")
    h0 = metrics.hists.get("llm.gen_time")
    n0, s0 = (h0.count, h0.total) if h0 else (0, 0.0)
    together = run_requests(eng, prompts, tok, LLM_NEW)
    h = metrics.hists["llm.gen_time"]
    gen_obs = {"count": h.count - n0, "mean_s": (h.total - s0) / max(1, h.count - n0)}
    alone = [run_requests(eng, [p], tok, LLM_NEW)["tokens"][0] for p in prompts]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_mem

    prefill_ms = {}
    for b in ecfg.prompt_buckets:
        ids = torch.zeros((1, b), dtype=torch.long, device="cuda")
        prefill_ms[b] = cuda_ms(lambda: eng._prefill_bucket(ids, b), iters=3)
    # the decode dispatch with every slot live (positions of the batched
    # run's prompts; the rows written land past them)
    with eng._lock:
        eng.pos = torch.tensor(plens, device="cuda")
        eng.done = torch.zeros(ecfg.batch_slots, dtype=torch.bool, device="cuda")
        dispatch_ms = cuda_ms(lambda: eng._step(), iters=LLM_TIMED, warmup=1)
        pos_end = int(eng.pos.max())
        # the same dispatches replayed from a CUDA graph: the card's own time,
        # without the host's launches (a measurement only; the engine runs
        # eagerly)
        dispatch_graph_ms = graph_ms(lambda: eng._step(), iters=2)
        eng.done = torch.ones(ecfg.batch_slots, dtype=torch.bool, device="cuda")
    K, B = ecfg.steps_per_dispatch, ecfg.batch_slots
    layer_bytes = quant.quantized_bytes(params["layers"]) + quant.quantized_bytes(params["ln_f"])
    head_bytes = quant.quantized_bytes(params["lm_head"])
    row_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2  # K and V, bf16
    mean_pos = float(np.mean(plens)) + LLM_TIMED * K / 2
    step_bytes = layer_bytes + head_bytes + B * mean_pos * row_bytes
    step_ops = 2.0 * B * (n_weights(params["layers"]) + n_weights(params["lm_head"]))
    b_ms, b_by = bound_ms(step_bytes, step_ops)
    step_ms = dispatch_ms / K
    emit("llm", card=card_info(), model="qwen2.5-7b dims, int8 weights (seeded codes; "
         "random embedding and readout), bf16", engine=dataclasses.asdict(ecfg) | {"dtype": "bf16"},
         init_s=init_s, warmup_s=warm_s, quantized_bytes=q_bytes, dense_bf16_bytes=dense_bytes,
         peak_bytes=peak, prompt_tokens=plens, prefill_ms=prefill_ms,
         decode_ms_per_dispatch=dispatch_ms, decode_graph_ms_per_dispatch=dispatch_graph_ms,
         decode_ms_per_step=step_ms,
         decode_ms_per_token=step_ms / B, step_bound_ms=b_ms, step_bound_by=b_by,
         step_bytes=step_bytes, timed_pos_end=pos_end,
         tokens_per_s=together["emitted"] / together["wall_s"], emitted=together["emitted"],
         dispatches=together["dispatches"], wall_s=together["wall_s"],
         gen_s=together["gen_s"], llm_gen_time=gen_obs,
         tokens_per_request=[len(t) for t in together["tokens"]])
    check(all(len(t) > 0 for t in together["tokens"]), "llm: a request emitted no token")
    check(together["tokens"] == alone, "llm: a request's tokens in the batch differ from "
          "the same request alone")
    check(gen_obs["count"] == len(prompts), f"llm: {gen_obs['count']} llm.gen_time "
          f"observations for {len(prompts)} requests")
    check(peak < dense_bytes, f"llm: peak memory {peak} B is not under the dense bf16 "
          f"weights' {dense_bytes} B")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()


# the trained tiny attendant LLM's system prompt (tools/train_tiny_llm.py
# SYSTEM_PROMPT; the script may not import the trainer, which imports JAX)
TINY_LLM_PROMPT = ("You are a helpful phone attendant. Be brief and "
                   "conversational.\nIf you have nothing to add, reply "
                   "exactly <nothingtosay>.")
GREETING = "hello this is the service team"


def attendant_turn(name: str, number: str, utterance=None) -> list:
    """A call's chat context as the attendant sees it: the system prompt and
    the metadata turn, then, with ``utterance``, the greeting and what the
    caller said."""
    msgs = [{"role": "system", "content": TINY_LLM_PROMPT},
            {"role": "user", "content": f"<incoming call from {name} ({number})>"}]
    if utterance is not None:
        msgs += [{"role": "assistant", "content": GREETING},
                 {"role": "user", "content": utterance}]
    return msgs


# (context, the policy's reply): contexts of the trainer's dialogue draw, one
# per policy branch the tiny model answers; tests/test_torch_tiny_llm.py
# holds each reply to tools/train_tiny_llm.policy and to the port on the CPU
LLM_TINY_CASES = tuple((attendant_turn(*c), reply) for *c, reply in (
    ("agent", "445572", None, GREETING),
    ("open", "890080", "transfer me to billing please", "will transfer you to billing now"),
    ("open", "890080", "transfer me to sales please", "will transfer you to sales now"),
    ("seis", "9447029", "<sentence interrupted>\ntransfer me to support please",
     "will transfer you to support now"),
    ("agent", "10839", "thanks goodbye", "thanks goodbye"),
    ("quatro", "91998", "hello good morning", "hello can help you"),
    ("segurar", "8263248", "cancel my order please", "will cancel that order now"),
    ("is", "7632", "check my account number please", "please repeat my account number"),
    ("de", "7746", "<sentence interrupted>\nisto tres speak", "<nothingtosay>"),
))


def phase_llm_tiny(torch):
    """Phase ``llm_tiny``: the trained tiny LLM through the port's loader
    in fp32 on the card (the tiny rule), served by the tiny-real actor's
    engine config; its greedy replies to ``LLM_TINY_CASES`` must be the
    policy's, word for word (a reply that differs is printed with its
    context)."""
    import dataclasses

    from infernos_tpu_torch.cluster.model_actors import LLM_TINY_REAL_ENGINE
    from infernos_tpu_torch.models import tiny_real
    from infernos_tpu_torch.models.tokenizers import ByteTokenizer
    from infernos_tpu_torch.serving.llm_engine import LLMEngine, apply_chat_template
    from infernos_tpu_torch.utils.platform import card_info

    params, cfg = tiny_real.load_tiny_llm("cuda")
    check(params["embed"]["w"].dtype == torch.float32, "llm_tiny: not served in fp32")
    ecfg = dataclasses.replace(LLM_TINY_REAL_ENGINE, dtype=torch.float32)
    tok = ByteTokenizer()
    eng = LLMEngine(params, cfg, ecfg, detokenize=tok.detokenize, device="cuda")
    eng.warmup()
    prompts = [apply_chat_template(ctx) for ctx, _ in LLM_TINY_CASES]
    run = run_requests(eng, prompts, tok)
    replies = [tok.detokenize(t) for t in run["tokens"]]
    flipped = [{"context": ctx[-1]["content"], "expected": want, "got": got}
               for (ctx, want), got in zip(LLM_TINY_CASES, replies) if got != want]
    emit("llm_tiny", card=card_info(), model="tiny-real qwen (D 192, 4 layers), fp32",
         replies=replies, flipped=flipped, wall_s=run["wall_s"], dispatches=run["dispatches"],
         gen_s=run["gen_s"])
    check(not flipped, f"llm_tiny: fp32 replies differ from the policy: {flipped}")


# -- phase 14: the AI attendant through SIP and the actors, in process --------

AIA_CALL_PORTS = {"sip": 25076, "rtp": (37000, 37400)}
# Alice's number: the app puts "<incoming call from 445572 (445572)>" in the
# call's first LLM turn (the trainer's dialogues carry a number there; after
# the bench phone's default caller "fakephone" the tiny model says "servis")
AIA_CALLER = "445572"
# what Alice says, its render seed, and what the attendant must answer (the
# policy of tools/train_tiny_llm.py).  The app merges her first utterance
# into the metadata turn, which the policy answers with the greeting.  The
# tiny STT was trained on utterances of one to four words
# (tools/train_tiny_stt.py), so she asks for billing in two: it hears
# "billing" in every render seed that tests/test_torch_aia_call.py tries
AIA_LINES = (("hello", 31, GREETING),
             ("billing please", 32, "will transfer you to billing now"))
# the VAD cuts 768-sample windows (serving/vad_engine.py) from 160-sample
# packets: every 24 packets the windows and packets line up again
VAD_PHASE_PACKETS = 24


def aia_config(sip_port: int, rtp, metrics_port=None) -> str:
    """The daemon config of one attendant (``examples/ai_attendant.yaml``):
    inbound calls go to AI attendant profile ``a1`` (en/en) with the tiny
    LLM's system prompt."""
    text = (f"sip:\n  settings:\n    bind: 127.0.0.1:{sip_port}\n  profiles:\n"
            f"    inbound:\n      sink: apps/ai_attendant/a1\n"
            f"rtp:\n  settings:\n    min_port: {rtp[0]}\n    max_port: {rtp[1]}\n"
            f"apps:\n  ai_attendant:\n    profiles:\n      a1:\n"
            f"        stt_lang: en\n        tts_lang: en\n"
            f"        llm_prompt: {json.dumps(TINY_LLM_PROMPT)}\n")
    if metrics_port:
        text += f"metrics:\n  port: {metrics_port}\n  bind: 127.0.0.1\n"
    return text


def drive_aia_call(device=None, on_ready=None) -> dict:
    """The AI attendant through SIP, in process: ``build_cluster`` spawns
    RTP, the attendant and SIP with the trained tiny-real trio
    (``INFERNOS_MODEL_MODE=tiny-real``: STT, LLM, TTS on Griffin-Lim) on
    ``device``; a ``FakePhone`` (Alice) calls in and says each line in turn
    as paced G.711 RTP, then keeps the line open with silence, so the
    app's 2 s flush sends the utterance to the LLM and the reply is said
    back; what she hears is kept until the app has played the reply out
    (:func:`wait_reply`).  ``on_ready()`` runs once the cluster is warm,
    right before the call.  Alice hangs up at the end and ``stop_all()``
    must leave no actor thread.  Returns, for each line, the STT texts and
    LLM reply texts (the app's debug log), the STT latency, LLM ``gen_time``
    and TTS first chunk (registry deltas), what Alice heard, what the TTS
    handed her leg (``said``: at 8 kHz through her codec) and the reply
    start; and the engines."""
    import tempfile

    from infernos_tpu_torch.audio.chunk import AudioChunk
    from infernos_tpu_torch.bench.phone import FakePhone
    from infernos_tpu_torch.cluster.actors import lookup, stop_all
    from infernos_tpu_torch.cluster.rtp_actor import RTPActor
    from infernos_tpu_torch.config import InfernConfig
    from infernos_tpu_torch.main import build_cluster
    from infernos_tpu_torch.utils.metrics import metrics
    from infernos_tpu_torch.utils.metrics_export import render_prometheus
    from infernos_tpu_torch.utils.platform import default_device

    timeout_s = 150.0 if default_device(device).type == "cpu" else 60.0
    ports = AIA_CALL_PORTS

    def registry() -> dict:
        return prom_values(render_prometheus(metrics.snapshot()))

    # what the TTS hands Alice's leg, copied before the leg resamples it
    said, soundout = [], RTPActor.rtp_session_soundout

    def tap(actor, sess_id, chunk):
        if isinstance(chunk, AudioChunk):
            said.append(AudioChunk(chunk.audio.copy(), chunk.samplerate))
        soundout(actor, sess_id, chunk)

    app_log, events = logging.getLogger("infernos_tpu_torch.apps.aia"), AppEvents()
    app_level = app_log.level
    alice = None
    out = {}
    with mock.patch.dict(os.environ, {"INFERNOS_MODEL_MODE": "tiny-real"}), \
            mock.patch.object(RTPActor, "rtp_session_soundout", tap):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "aia.yaml")
            with open(path, "w") as f:
                f.write(aia_config(ports["sip"], ports["rtp"]))
            iconf = InfernConfig(path)
        try:
            app_log.addHandler(events)
            app_log.setLevel(logging.DEBUG)
            t0 = time.perf_counter()
            handles = build_cluster(iconf, tiny=True, bind_ip="127.0.0.1", device=device)
            out["boot_s"] = time.perf_counter() - t0
            engines = {m: lookup(f"{m}:a1")._actor.engine for m in ("stt", "llm", "tts")}
            engines["stt"].encode_ms.clear()
            engines["tts"].tick_ms.clear()
            engines["tts"].tick_frames.clear()
            out.update(engines, handles=sorted(handles))
            alice = FakePhone()
            if on_ready is not None:
                on_ready()
            t_call = time.monotonic()
            alice.call(iconf.sip_conf.bind, cli=AIA_CALLER)
            check(alice.uac.connected, "aia call: the call was not answered")
            seq0 = alice._packetizer.seq
            turns, stream = [], None
            for text, seed, expect in AIA_LINES:
                if stream is not None:  # one sender at a time on her leg
                    alice.stop_streaming()
                    stream.join(10.0)
                    check(not stream.is_alive(), "aia call: Alice's sender did not stop")
                n_before, base, seen = len(alice.rx_packets), registry(), dict(events.counts)
                n_texts, n_llm, n_said = len(events.stt_texts), len(events.llm_texts), len(said)
                # the silence she sent while the reply played depends on the
                # clock: pad it to a whole number of VAD window cycles, so
                # that the VAD cuts each line at the same phase in every run
                sent = (alice._packetizer.seq - seq0) & 0xFFFF
                lead = np.zeros(FRAME_BYTES * (-sent % VAD_PHASE_PACKETS), np.float32)
                audio = np.concatenate([lead, render_speech(text, seed)])
                t_send = time.monotonic()
                stream = alice.stream_bg(audio, then_silence=True)
                t_last = t_send + (len(audio) // FRAME_BYTES - 1) * 0.020
                heard = wait_reply(alice, n_before, timeout_s,
                                   lambda: says_over(events, seen, t_last, llm=True))
                check(heard, f"aia call: no reply to {text!r} within {timeout_s} s")
                t_first = first_sound_at(alice, n_before)
                work = calls_work(base, registry())
                turns.append(types.SimpleNamespace(
                    text=text, expect=expect, speech_s=len(audio) / 8000,
                    stt_text=events.stt_texts[n_texts:], llm_text=events.llm_texts[n_llm:],
                    stt_results=work["stt_audio_s"]["count"],
                    stt_latency_s=work["stt_inf_time"]["mean"],
                    llm_gen_s=work["llm_gen_time"]["mean"], llm_replies=work["llm_gen_time"]["count"],
                    says=work["tts_ttfb"]["count"], first_chunk_s=work["tts_ttfb"]["mean"],
                    tts_samples=work["tts_audio_samples"], tts_rate=engines["tts"].ecfg.sample_rate,
                    rx=rx_audio(alice, n_before), rx_packets=len(alice.rx_packets) - n_before,
                    said=alice.codec.decode(alice.codec.encode(np.concatenate(
                        [np.zeros(0, np.float32)] + [c.resample(8000).audio
                                                     for c in said[n_said:]]))),
                    reply_start_s=None if t_first is None else t_first - t_last))
            alice.stop_streaming()
            out["call_s"] = time.monotonic() - t_call
            out["turns"] = turns
            alice.hangup()
            deadline = time.monotonic() + 10.0
            aia = lookup("apps/ai_attendant/a1")._actor
            while aia.sessions and time.monotonic() < deadline:
                time.sleep(0.05)
            out["sessions_left"] = len(aia.sessions)
        finally:
            if alice is not None:
                alice.close()
            stop_all()
            app_log.removeHandler(events)
            app_log.setLevel(app_level)
    time.sleep(0.5)
    out["actor_threads_left"] = [t.name for t in threading.enumerate()
                                 if t.name.startswith("actor:") and t.is_alive()]
    return out


# the pacer's muxer hands the native pacer 100 ms blocks (5 packets) and
# pads a say's last block with silence when the say ends
MUX_BLOCK_PACKETS = 5


def carries_says(packets: int, samples: float, rate: int, says: float) -> bool:
    """Whether ``packets`` at 8 kHz hold the ``samples`` (at ``rate``) of
    ``says`` says: none lost, and less than a block of padding a say."""
    want = samples * 8000 / rate / FRAME_BYTES
    return says >= 1 and want <= packets < want + MUX_BLOCK_PACKETS * says


def reply_checks(turns) -> list:
    """Per line of an attendant call: the LLM's reply (the app's log) must be
    the policy's reply, the says must have ended, and Alice's packets must
    carry the audio the TTS engine emitted for them (:func:`carries_says`)
    with sound in it.  Returns the failures."""
    bad = []
    for t in turns:
        pkts = t.tts_samples * 8000 / t.tts_rate / FRAME_BYTES
        peak = float(np.abs(t.rx).max()) if len(t.rx) else 0.0
        if " ".join(t.llm_text) != t.expect:
            bad.append(f"after {t.text!r} the LLM said {t.llm_text!r}, not {t.expect!r}")
        if not carries_says(t.rx_packets, t.tts_samples, t.tts_rate, t.says) or peak <= SILENT:
            bad.append(f"after {t.text!r} Alice got {t.rx_packets} packets (peak {peak}) "
                       f"for the {pkts} that {t.says} says filled")
    return bad


def heard_checks(stt_eng, turns):
    """Per line of an attendant call: what Alice heard and what the TTS
    handed her leg, each transcribed by ``stt_eng``.  The heard transcript
    must reach word accuracy ``ACC_MIN`` against the said one: her leg
    carries what the TTS said.  Against the policy's reply the accuracy is
    reported, not held: the tiny STT, trained on one to four words, hears
    these six-word replies badly even from the clean speech renderer, alike
    in both packages (tests/test_torch_aia_call.py).  Returns (rows,
    failures)."""
    rows, bad = [], []
    for t in turns:
        heard = transcribe(stt_eng, active_region(t.rx), "en")
        said = transcribe(stt_eng, active_region(t.said), "en")
        acc = word_acc(said, heard)
        rows.append({"heard": heard, "said": said, "heard_vs_said": acc,
                     "expected": t.expect, "word_acc": word_acc(t.expect, heard)})
        if acc < ACC_MIN:
            bad.append(f"after {t.text!r} Alice heard {heard!r} where the TTS said "
                       f"{said!r} (word accuracy {acc} < {ACC_MIN})")
    return rows, bad


def phase_aia_call(torch, attn, ts):
    """Phase ``aia_call``: :func:`drive_aia_call` on the card (fp32,
    Griffin-Lim).  Checks, per line: the LLM's reply is the policy's (the
    greeting, then the transfer), the says ended and Alice's packets carry
    the audio the TTS emitted (:func:`reply_checks`), and what she heard
    reaches word accuracy 0.6 against what the TTS said
    (:func:`heard_checks`, which also prints it against the policy's reply);
    the kernels the warm cluster's call went through: kernel 1 twice per
    encode (the tiny STT's 2 layers) in its fp32 mode, kernel 2 over fp32
    caches once per TTS step, no other mode; the session ends at the
    hang-up and no actor thread is left.  Returns the launch counts (the
    fp32 modes of kernels 1 and 2)."""
    from infernos_tpu_torch.utils.platform import card_info

    call = drive_aia_call(on_ready=reset_launch_counts)
    torch.cuda.synchronize()
    attn_launches, fp32_steps = path_launches(launch_counts(), "aia call", fp32=True)
    stt, tts, llm = call["stt"], call["tts"], call["llm"]
    check(all(e.device.type == "cuda" for e in (stt, tts, llm))
          and stt.ecfg.dtype == llm.ecfg.dtype == tts.ecfg.dtype == torch.float32,
          "aia call: the attendant's engines do not serve fp32 on the card")
    encodes = len(stt.encode_ms)
    steps = sum(n // tts.cfg.reduction_factor for n in tts.tick_frames)
    heard, unheard = heard_checks(stt, call["turns"])
    out = [{"alice_said": t.text, "speech_s": t.speech_s, "stt_text": t.stt_text,
            "llm_text": t.llm_text, "stt_results": t.stt_results,
            "stt_latency_s": t.stt_latency_s, "llm_gen_time_s": t.llm_gen_s,
            "llm_replies": t.llm_replies, "says": t.says,
            "tts_first_chunk_s": t.first_chunk_s, "reply_start_s": t.reply_start_s,
            "packets": t.rx_packets, "tts_samples": t.tts_samples,
            "rx_s": len(t.rx) / 8000} | h for t, h in zip(call["turns"], heard)]
    emit("aia_call", card=card_info(), model="tiny-real STT + LLM + TTS (fp32, Griffin-Lim)",
         boot_s=call["boot_s"], call_s=call["call_s"], actors=call["handles"], turns=out,
         word_acc_bar=ACC_MIN, attention_fp32_launches=attn_launches,
         fp32_step_launches=fp32_steps, stt_encodes=encodes, tts_steps_run=steps,
         encode_ms=stt.encode_ms, tts_ms_per_tick=tts.tick_ms,
         sessions_left=call["sessions_left"], actor_threads_left=call["actor_threads_left"])
    bad = reply_checks(call["turns"]) + unheard
    check(not bad, f"aia call: {bad}")
    check(encodes > 0 and attn_launches == stt.cfg.encoder_layers * encodes,
          f"aia call: attention kernel launched {attn_launches} times for {encodes} "
          f"encodes, want {stt.cfg.encoder_layers} each")
    check(steps > 0 and fp32_steps == steps,
          f"aia call: fp32-cache step kernel launched {fp32_steps} times for {steps} steps")
    check(call["sessions_left"] == 0, "aia call: the session outlived the hang-up")
    check(not call["actor_threads_left"],
          f"aia call: actor threads left after stop_all: {call['actor_threads_left']}")
    return attn_launches, fp32_steps


# -- phase 15: the daemon at full width with the AI attendant -----------------

DAEMON_AIA_PORTS = {"sip": 25272, "metrics": 25292, "rtp": (38000, 38400)}
# one utterance (two before): a depth cut that makes room in the script's
# time for ckpt_port's porter runs; the second turn took the first's path
DAEMON_AIA_SAYINGS = (("please help now", 25),)
DAEMON_AIA_REPLY_S = 300.0  # per utterance: STT, the 2 s flush, LLM, TTS, playout


def phase_daemon_aia(torch):
    """Phase ``daemon_aia``: ``python -m infernos_tpu_torch -f cfg.yaml``
    with an ``ai_attendant`` profile (``examples/ai_attendant.yaml``'s, en/en)
    in a subprocess at full width with zero weights: Whisper-large-v3 in the
    tiered engine, Qwen2.5-7B in the int8 layout, SpeechT5 + HiFi-GAN +
    AmendNet, bf16, ``INFERNOS_STT_MAX_NEW=16``.  One call; Alice says
    each of ``DAEMON_AIA_SAYINGS`` once the reply to the one before has been
    played out.
    Checks, on ``/metrics`` after the warm-ups: an STT result per segment,
    an ``llm.gen_time`` per flushed utterance, a finished say, no driver
    crash and nothing quarantined; Alice's leg carries paced RTP (p50 gap
    15-25 ms) holding the audio the TTS engine emitted; exit 0 within 30 s
    of SIGTERM; the call's kernel launches apart from the warm-ups' (kernel
    1 once per encoder layer per encode, kernel 2 bf16 once per TTS step,
    int8 never).  Returns the call's launch counts (attention, bf16 step)."""
    from infernos_tpu_torch.bench.phone import FakePhone
    from infernos_tpu_torch.utils.platform import card_info

    p = DAEMON_AIA_PORTS
    torch.cuda.empty_cache()
    with daemon(aia_config(p["sip"], p["rtp"], metrics_port=p["metrics"]),
                p["sip"], p["metrics"]) as d:
        warm = daemon_work(d.proc, d.work_path)
        alice = FakePhone()
        d.closers.append(alice.close)
        t_call = time.monotonic()
        alice.call(("127.0.0.1", p["sip"]), timeout=60.0, cli=AIA_CALLER)
        check(alice.uac.connected, "daemon_aia: the call was not answered")
        turns, stream = [], None
        for k, (text, seed) in enumerate(DAEMON_AIA_SAYINGS, start=1):
            if stream is not None:
                alice.stop_streaming()
                stream.join(1.0)
            n_before = len(alice.rx_packets)
            stream = alice.stream_bg(render_speech(text, seed), then_silence=True)
            deadline = time.monotonic() + DAEMON_AIA_REPLY_S
            while True:  # the reply made: STT, LLM and a say ended
                new = calls_work(d.base, scrape_metrics(p["metrics"]))
                if (new["stt_audio_s"]["count"] >= k and new["llm_gen_time"]["count"] >= k
                        and new["tts_session_s"]["count"] >= k):
                    break
                check(d.proc.poll() is None, "daemon_aia: the daemon exited during the call")
                check(time.monotonic() < deadline,
                      f"daemon_aia: no reply to utterance {k} on /metrics in "
                      f"{DAEMON_AIA_REPLY_S} s: {new}")
                time.sleep(1.0)
            # playout: until Alice's leg has been quiet for 2 s (at most 60 s)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and (
                    len(alice.rx_packets) == n_before
                    or time.monotonic() - alice.rx_packets[-1][0] < 2.0):
                time.sleep(0.2)
            turns.append({"said": text, "packets": len(alice.rx_packets) - n_before,
                          "reply_s": time.monotonic() - t_call})
        call_s = time.monotonic() - t_call
        m = scrape_metrics(p["metrics"])
        new = calls_work(d.base, m)
        done = daemon_work(d.proc, d.work_path)
        calls = {k: done[k] - warm[k] for k in
                 ("attention", "bf16_step", "int8_step", "encodes", "steps")}
        leg = pacing([t for t, _ in alice.rx_packets])
        alice.stop_streaming()
        alice.hangup()
        rc, stop_s = d.terminate()
        tts_pkts = new["tts_audio_samples"] * 8000 / done["tts_rate"] / FRAME_BYTES
        says = new["tts_session_s"]["count"]
        emit("daemon_aia", card=card_info(), model="whisper-large-v3 (tiered) + qwen2.5-7b "
             "(int8) + SpeechT5 + HiFi-GAN + AmendNet, bf16, zero weights",
             boot_s=d.boot_s, call_s=call_s, turns=turns, leg=leg, calls_work=new,
             metrics={k: v for k, v in m.items() if k.startswith(
                 ("infernos_stt", "infernos_tts", "infernos_llm", "infernos_driver"))},
             tts_packets=tts_pkts, exit_code=rc, stop_s=stop_s,
             launches={"warm_up": {k: warm[k] for k in calls}, "calls": calls})
        n = len(DAEMON_AIA_SAYINGS)
        check(rc == 0, f"daemon_aia: exit code {rc} after SIGTERM (want 0 within "
                       f"{DAEMON_STOP_S} s)")
        check(m.get("infernos_driver_crashes", 0) == 0, "daemon_aia: an engine driver crashed")
        check(new["stt_poisoned_requests"] == 0 and new["tts_poisoned_sessions"] == 0
              and new["llm_poisoned_requests"] == 0,
              f"daemon_aia: quarantined work during the call: {new}")
        check(new["stt_audio_s"]["count"] >= n and new["llm_gen_time"]["count"] >= n
              and says >= 1, f"daemon_aia: the call's STT, LLM or TTS work fell short: {new}")
        check(leg["packets"] >= 10 and 15.0 <= leg["gap_ms_p50"] <= 25.0,
              f"daemon_aia: Alice did not receive paced RTP: {leg}")
        check(carries_says(leg["packets"], new["tts_audio_samples"], done["tts_rate"], says),
              f"daemon_aia: Alice got {leg['packets']} packets for the {tts_pkts} that "
              f"{says} says filled")
        check(1 <= calls["encodes"] <= new["stt_audio_s"]["count"]
              and calls["attention"] == done["encoder_layers"] * calls["encodes"],
              f"daemon_aia: attention kernel launched {calls['attention']} times for "
              f"{calls['encodes']} encodes, want {done['encoder_layers']} each")
        check(calls["steps"] > 0 and calls["bf16_step"] == calls["steps"],
              f"daemon_aia: bf16 step kernel launched {calls['bf16_step']} times for "
              f"{calls['steps']} steps")
        path_launches(done, "daemon_aia", fp32=False)  # full width: the bf16 modes alone
        d.ok = True
    return calls["attention"], calls["bf16_step"]


# -- phases 16-19: the benches, each its own entry in a subprocess ----------

# runs ``python -m <module> <args>`` as the bench's own main; counts the
# kernels' launches from 0 and keeps every STT and TTS engine made, and
# writes the launches with the engines' encodes and steps to
# ``$CHIP_SMOKE_WORK.warm`` after every engine's ``warmup`` and when
# ``build_cluster`` returns (so it holds the work up to the last warm-up,
# the path's start) and to ``$CHIP_SMOKE_WORK.done`` at the end, also when
# the bench ends its process with ``os._exit``
BENCH_PRELUDE = """
import importlib, json, os, sys, threading
import infernos_tpu_torch.main as entry
from infernos_tpu_torch.ops import launch_counts, reset_launch_counts
from infernos_tpu_torch.serving import stt_engine, tts_engine

made = {"stt": [], "tts": []}


def keep(cls, kind):
    init = cls.__init__

    def wrapped(self, *a, **kw):
        init(self, *a, **kw)
        made[kind].append(self)
    cls.__init__ = wrapped


def report(tag):  # written whole, then renamed: actors warm up in threads
    work = {**launch_counts(),
            "encoder_layers": sorted({e.cfg.encoder_layers for e in made["stt"]}),
            "encodes": sum(len(e.encode_ms) for e in made["stt"]),
            "encoder_layer_runs": sum(e.cfg.encoder_layers * len(e.encode_ms) for e in made["stt"]),
            "steps": sum(n // e.cfg.reduction_factor for e in made["tts"]
                         for n in list(e.tick_frames))}
    path = os.environ["CHIP_SMOKE_WORK"] + "." + tag
    with open(f"{path}.{threading.get_ident()}", "w") as f:
        json.dump(work, f)
    os.replace(f.name, path)


def build_cluster(*a, build=entry.build_cluster, **kw):
    handles = build(*a, **kw)
    report("warm")
    return handles


def warm_then_report(cls):
    warmup = cls.warmup

    def wrapped(self):
        warmup(self)
        report("warm")
    cls.warmup = wrapped


def exit_now(rc, real=os._exit):
    report("done")
    real(rc)


keep(stt_engine.STTEngine, "stt")
keep(tts_engine.TTSEngine, "tts")
warm_then_report(stt_engine.STTEngine)
warm_then_report(tts_engine.TTSEngine)
entry.build_cluster = build_cluster
os._exit = exit_now
reset_launch_counts()
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
importlib.import_module(module).main()
report("done")
"""
LAUNCH_KEYS = (*ATTN_KEY.values(), *STEP_KEY.values(), CROSS_KEY)
WORK_KEYS = (*LAUNCH_KEYS, "encodes", "encoder_layer_runs", "steps")


def run_bench(name: str, module: str, args, timeout: float, env_extra=None) -> dict:
    """``python -m module args`` under ``BENCH_PRELUDE`` on the card (no
    tiny, tiny-real or CPU mode from this process's environment), at most
    ``timeout`` s.  Returns its exit code, seconds, standard output and
    error, JSON lines, and the work it reported (``warm``: after its
    cluster's start, if it built one; ``done``: at its end).  Prints its
    standard error's tail when it exits non-zero."""
    import subprocess
    import tempfile

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    work = os.path.join(tmp, "work")
    env = {k: v for k, v in os.environ.items()
           if k not in ("INFERNOS_MODEL_MODE", "INFERNOS_DEVICE", "INFERNOS_TINY")}
    env.update(env_extra or {}, CHIP_SMOKE_WORK=work)
    t0 = time.monotonic()
    with open(os.path.join(tmp, "out"), "w+") as out, open(os.path.join(tmp, "err"), "w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", BENCH_PRELUDE, module, *args],
                                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                                stdout=out, stderr=err, stdin=subprocess.DEVNULL)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        out.seek(0)
        err.seek(0)
        r = types.SimpleNamespace(rc=rc, seconds=time.monotonic() - t0, out=out.read(),
                                  err=err.read())
    r.lines = []
    for ln in r.out.splitlines():
        if ln.startswith("{"):
            with contextlib.suppress(json.JSONDecodeError):
                r.lines.append(json.loads(ln))
    r.work = {}
    for tag in ("warm", "done"):
        with contextlib.suppress(FileNotFoundError):
            with open(f"{work}.{tag}") as f:
                r.work[tag] = json.load(f)
    if rc != 0:
        print(f"---- {name}: {module} exited {rc}; standard error ends ----\n"
              + r.err[-8000:], file=sys.stderr, flush=True)
    return r


def bench_launches(r, name: str, stt: bool = True, tts: bool = True,
                   fp32: bool = False) -> dict:
    """The kernels a bench run launched on its path (after its engines'
    last warm-up or its cluster's start; its whole run when it warmed up
    nothing, as ``ttsprobe``, whose first tick is its own), held to
    its engines' work: kernel 1 once per encoder layer per encode, kernel 2
    (dense weights) once per TTS step, in the bf16 modes at full width and
    the fp32 modes with ``fp32`` (tiny-real); no other mode, in its whole
    run.  ``stt``/``tts``: whether the bench runs that engine (its kernel
    must then launch, else never).  The path's counts in its modes come
    back under ``kernel1`` and ``kernel2`` beside every mode's."""
    check("done" in r.work, f"{name}: the bench reported no kernel launches")
    done, warm = r.work["done"], r.work.get("warm", dict.fromkeys(WORK_KEYS, 0))
    calls = {k: done[k] - warm[k] for k in WORK_KEYS}
    path_launches(done, name, fp32)  # no launch of another mode, warm-ups included
    calls["kernel1"], calls["kernel2"] = path_launches(calls, name, fp32)
    check(calls["kernel1"] == calls["encoder_layer_runs"]
          and (calls["encodes"] > 0) == stt,
          f"{name}: attention kernel launched {calls['kernel1']} times for "
          f"{calls['encodes']} encodes of {done['encoder_layers']} layers")
    check(calls["kernel2"] == calls["steps"] and (calls["steps"] > 0) == tts,
          f"{name}: step kernel launched {calls['kernel2']} times for "
          f"{calls['steps']} steps")
    return calls


# BENCH_SECONDS: each paced level's measuring window (halved from 8 s to make
# room for ckpt_port in the time limit; the levels, the probe and every
# check stay)
PACED_TTS_SECONDS = "4"


def phase_paced_tts(torch):
    """Phase ``paced_tts``: ``python -m infernos_tpu_torch.bench.ttsmain``
    (SpeechT5 + HiFi-GAN at full width, zero weights, bf16, 24 slots,
    async harvest) with 4 s levels.  Checks: its JSON line parses, every
    level spoke (utterances > 0), the bf16 step kernel launched once per
    TTS step and int8 never.  Prints the paced calls at p95 TTFB < 200 ms
    with no underruns, the probe's streams, each level's TTFB and tick.
    Returns the bf16 step launches."""
    from infernos_tpu_torch.utils.platform import card_info

    r = run_bench("paced_tts", "infernos_tpu_torch.bench.ttsmain", [], timeout=300,
                  env_extra={"BENCH_SECONDS": PACED_TTS_SECONDS})
    check(r.rc == 0, f"paced_tts: ttsmain exited {r.rc}")
    check(r.lines and r.lines[-1].get("metric") == "tts_paced_concurrent_calls_per_chip",
          f"paced_tts: no result line: {r.out[-2000:]}")
    res = r.lines[-1]
    calls = bench_launches(r, "paced_tts", stt=False)
    d = res["detail"]
    emit("paced_tts", card=card_info(), seconds=r.seconds, paced_calls=res["value"],
         unit=res["unit"], probe_streams=d["throughput_streams_probe"],
         batch_slots=d["batch_slots"], utterance_frames=d["utterance_frames"],
         best_ttfb_p50_s=d["best_ttfb_p50_s"], best_ttfb_p95_s=d["best_ttfb_p95_s"],
         levels=d["levels"], warmup_s=d["warmup_s"], device=d["device"], launches=calls)
    check(d["platform"] == "gpu" and d["device"] == torch.cuda.get_device_name(0),
          f"paced_tts: the bench ran on {d['platform']} {d['device']}")
    check(d["levels"] and all(lv["utterances"] > 0 for lv in d["levels"]),
          f"paced_tts: a level spoke no utterance: {d['levels']}")
    return calls["kernel2"]


def phase_lt_bench_tiny(torch):
    """Phase ``lt_bench_tiny``: ``python -m infernos_tpu_torch.bench.ltbench
    --tiny-real --calls 4 --turns 2``: four concurrent two-leg calls through
    SIP, the actors, VAD, the trained tiny STT, T2T and the tiny TTS
    (fp32), each Alice speaking two speech-language lines.  Checks: 4
    answered, 8 turns measured, no failed turn, the child's exit 0, and the
    calls' kernel launches in the fp32 modes (kernel 1 = 2 x encodes).
    Prints the turn latency p50/p95.  Returns the calls' launches (kernels
    1 and 2)."""
    from infernos_tpu_torch.utils.platform import card_info

    r = run_bench("lt_bench_tiny", "infernos_tpu_torch.bench.ltbench",
                  ["--tiny-real", "--calls", "4", "--turns", "2"], timeout=300)
    res = r.lines[-1] if r.lines else {}
    calls = bench_launches(r, "lt_bench_tiny", fp32=True) if r.rc == 0 else None
    emit("lt_bench_tiny", card=card_info(), seconds=r.seconds, exit_code=r.rc, result=res,
         launches=calls)
    check(r.rc == 0, f"lt_bench_tiny: ltbench exited {r.rc}")
    check(res.get("answered") == 4 and res.get("turns") == 8 and res.get("failures") == 0,
          f"lt_bench_tiny: want 4 answered, 8 turns measured, 0 failures: {res}")
    check(r.work["done"]["encoder_layers"] == [2],
          f"lt_bench_tiny: encoder layers {r.work['done']['encoder_layers']}, want the tiny STT's 2")
    return calls["kernel1"], calls["kernel2"]


LT_RAMP_LEVELS = "1,2"  # level 4 never passed (lt_calls_per_chip 1-2); its tries cost most
LT_RAMP_TURNS = 1  # turns per call (the flagship's 2): a depth cut to fit the script's time
LT_RAMP_ENV = {"INFERNOS_STT_MAX_NEW": "24", "INFERNOS_TTS_SLOTS": "32",
               "INFERNOS_STT_SLOTS": "24"}  # the flagship's defaults


def phase_lt_ramp(torch):
    """Phase ``lt_ramp``: ``python -m infernos_tpu_torch.bench.ltbench
    --ramp --full --turns 1`` at full width (Whisper-large-v3 tiered STT,
    24 + 8 slots; two SpeechT5 + HiFi-GAN + AmendNet TTS engines of 32
    slots; bf16, zero weights; ``INFERNOS_STT_MAX_NEW`` 24, as the flagship
    runs it) on the ladder ``LT_RAMP_LEVELS``.  Checks, not SLAs: the child
    exits 0; the first level answers every call and measures every turn; a
    JSON line after each level; the calls' kernel launches (kernel 1 = 32 x
    encodes, kernel 2 bf16 = steps).  Prints ``lt_calls_per_chip``, each
    level's turn p50/p95 and wall time, the startup and each level's
    engine-stage snapshot.  Returns the calls' launches (attention, bf16
    step)."""
    from infernos_tpu_torch.utils.platform import card_info

    torch.cuda.empty_cache()
    r = run_bench("lt_ramp", "infernos_tpu_torch.bench.ltbench",
                  ["--ramp", "--full", "--turns", str(LT_RAMP_TURNS),
                   "--levels", LT_RAMP_LEVELS],
                  timeout=600, env_extra=LT_RAMP_ENV)
    ramp = [ln for ln in r.lines if ln.get("metric") == "lt_calls_per_chip"]
    res = ramp[-1] if ramp else {}
    levels = res.get("detail", {}).get("levels", [])
    snapshots = [ln for ln in r.err.splitlines() if " engine metrics: " in ln]
    calls = bench_launches(r, "lt_ramp") if r.rc == 0 else None
    emit("lt_ramp", card=card_info(), seconds=r.seconds, exit_code=r.rc,
         lt_calls_per_chip=res.get("value"), unit=res.get("unit"),
         startup_s=res.get("detail", {}).get("startup_s"), levels=levels,
         engine_metrics=snapshots, json_lines=len(ramp), launches=calls)
    check(r.rc == 0, f"lt_ramp: ltbench exited {r.rc}")
    check(levels and levels[0]["n_calls"] == 1 and levels[0]["answered"] == 1
          and levels[0]["turns_measured"] == LT_RAMP_TURNS and levels[0]["failures"] == 0,
          f"lt_ramp: the first level did not answer its call and measure every turn: "
          f"{levels[:1]}")
    # one line after each level, one before each retry, and the result
    check(len(ramp) >= len(levels) + 1,
          f"lt_ramp: {len(ramp)} JSON lines for {len(levels)} levels")
    check(len(snapshots) == len(levels),
          f"lt_ramp: {len(snapshots)} engine snapshots for {len(levels)} levels")
    check(r.work["done"]["encoder_layers"] == [32],
          f"lt_ramp: encoder layers {r.work['done']['encoder_layers']}, want large-v3's 32")
    check(calls["encodes"] >= 2, f"lt_ramp: {calls['encodes']} encodes in the levels")
    return calls["kernel1"], calls["kernel2"]


def phase_loopback(torch):
    """Phase ``loopback``: ``python -m infernos_tpu_torch.bench.loopback
    --speakers 4 --prompts 2``: the tiny-real TTS speaks each prompt in each
    voice (fp32), the tiny-real STT transcribes it.  Checks: the mean
    similarity reaches ``LOOPBACK_BAR`` (the reference package's mean on
    the same cells on the CPU, less 0.1), the kernel launches in the fp32
    modes.  Prints the mean, its distribution and the cells' transcripts.
    Returns the launches (kernels 1 and 2)."""
    from infernos_tpu_torch.utils.platform import card_info

    r = run_bench("loopback", "infernos_tpu_torch.bench.loopback",
                  ["--speakers", "4", "--prompts", "2"], timeout=300)
    check(r.rc == 0 and r.lines, f"loopback: the bench exited {r.rc}")
    res = r.lines[-1]
    calls = bench_launches(r, "loopback", fp32=True)
    emit("loopback", card=card_info(), seconds=r.seconds, similarity=res["value"],
         bar=LOOPBACK_BAR, detail=res["detail"], launches=calls)
    check(res["detail"]["voices_scored"] == 4 and res["detail"]["prompts_per_voice"] == 2,
          f"loopback: scored {res['detail']}")
    check(res["value"] >= LOOPBACK_BAR,
          f"loopback: mean similarity {res['value']} under the bar {LOOPBACK_BAR:.4f}")
    return calls["kernel1"], calls["kernel2"]


# -- phases 20-27: the quality ladder, the engine and attendant benches, the
# echo loop and a profiled ramp level ------------------------------------------

LADDER_REQUESTS = (2.0, 3.5, 5.25, 8.0)  # seconds of audio per request
LADDER_TEMPS = (0.5, 1.0)
LADDER_BEAM = 5
LADDER_NEW = 24  # random weights never emit EOS
HF_INIT_STD = 0.02  # HF WhisperConfig.init_std
DECODER_KEYS = ("tok_embed", "dec_pos", "dec_layers", "dec_ln")


def hf_init_decoder(torch, params, generator):
    """A decoder tree shaped as ``params``' with HF Whisper's init: every
    weight and embedding N(0, 0.02), biases 0, LayerNorms 1 and 0.  The
    port's ``init_params`` (torch.nn defaults) gives the embedding N(0, 1),
    which outweighs every layer's output: that decoder repeats its input
    token with probability 1, so sampling, beams and greedy all agree."""
    def leaf(k, t):
        if k == "g":
            return torch.ones_like(t)
        if k == "b":
            return torch.zeros_like(t)
        return torch.empty_like(t).normal_(0.0, HF_INIT_STD, generator=generator)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in tree.items()}
    return walk({k: params[k] for k in DECODER_KEYS})


def phase_stt_ladder(torch, attn, stt_params=None):
    """Phase ``stt_ladder``: the STT engine at whisper-large-v3 width
    (seeded random bf16 weights, the decoder at HF Whisper's init, 8 slots,
    24 new tokens) with the quality ladder on: temperatures 0.5 and 1.0,
    then a beam of 5.  Random weights fail the gate on every result, so
    each request is decoded greedily, then at each temperature, then once
    by beam search.  Checks: each callback fires once, with the beam's
    result (temperature 0; a failed beam re-decode keeps 1.0); every
    sampled rung's tokens differ from the greedy decode's;
    ``stt.fallback_retries`` grows by 2 per request and
    ``stt.beam_redecodes`` by 1; kernel 1 launches 32 times per encode (the
    joins' and the beam re-decodes').  Then, in fp32 (TF32 off) on one
    encoded utterance: ``beam_decode`` with W 1 gives the ids of a greedy
    loop over ``decode_step`` on a fresh cache, that greedy decode holds
    more than one distinct token, each beam's sum logprob equals its
    tokens' rescored by a teacher-forced loop (within 1e-4 relative: the
    parent gathers of the self K/V cache are right), and W 5's sum logprob
    is above W 1's.
    Returns the kernel-1 launches of the engine's run."""
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.models.convert import cast_floating
    from infernos_tpu_torch.serving import stt_engine as stt
    from infernos_tpu_torch.utils.metrics import metrics

    cfg = wsp.WhisperConfig()
    if stt_params is None:  # the stt phase's weights when it did not run
        g = torch.Generator(device="cuda").manual_seed(5)
        stt_params = wsp.init_params(cfg, g, "cuda", torch.bfloat16)
    dec = hf_init_decoder(torch, stt_params, torch.Generator(device="cuda").manual_seed(6))
    ecfg = stt.STTEngineConfig(dtype=torch.bfloat16, batch_slots=8,
                               max_new_tokens=LADDER_NEW,
                               fallback_temperatures=LADDER_TEMPS,
                               fallback_beam_size=LADDER_BEAM)
    eng = stt.STTEngine({**stt_params, **dec}, cfg, ecfg)
    rng = np.random.default_rng(11)
    audios = [synth_audio(rng, s) for s in LADDER_REQUESTS]
    results = {i: [] for i in range(len(audios))}
    reqs = [stt.STTRequest(audio=a, text_cb=results[i].append)
            for i, a in enumerate(audios)]
    rungs = {id(r): [] for r in reqs}  # (temperature, tokens) of each decode
    needs_fallback = eng._needs_fallback

    def gate(req, res):
        rungs[id(req)].append((res.temperature, list(res.tokens)))
        return needs_fallback(req, res)
    eng._needs_fallback = gate
    before = {k: metrics.counters.get(k, 0) for k in ("stt.fallback_retries",
                                                       "stt.beam_redecodes")}
    reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.step() and steps < 2000:
        steps += 1
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = path_launches(launch_counts(), "stt_ladder", fp32=False)[0]  # right after it
    encodes = len(eng.encode_ms)
    grew = {k: metrics.counters.get(k, 0) - v for k, v in before.items()}
    n = len(audios)
    check(all(len(v) == 1 for v in results.values()),
          f"stt_ladder: callbacks per request {[len(v) for v in results.values()]}")
    check(all(r.attempt == len(LADDER_TEMPS) and r.beam_done for r in reqs),
          f"stt_ladder: attempts {[r.attempt for r in reqs]}, "
          f"beam {[r.beam_done for r in reqs]}")
    check(grew == {"stt.fallback_retries": 2 * n, "stt.beam_redecodes": n},
          f"stt_ladder: counters grew {grew}, want {2 * n} retries and {n} beams")
    check(encodes == 4 * n, f"stt_ladder: {encodes} encodes, want {4 * n}")
    check(launches == cfg.encoder_layers * encodes,
          f"stt_ladder: attention kernel launched {launches} times for {encodes} encodes")
    res = [results[i][0] for i in range(n)]
    for i, r in enumerate(res):
        check(0 < len(r.tokens) <= LADDER_NEW and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"stt_ladder request {i}: tokens {r.tokens}")
        check(math.isfinite(r.avg_logprob), f"stt_ladder request {i}: avg logprob")
        check(r.temperature == 0.0, f"stt_ladder request {i}: delivered at temperature "
              f"{r.temperature}, not the beam's result")
        temps = [t for t, _ in rungs[id(reqs[i])]]
        check(temps == [0.0, *LADDER_TEMPS], f"stt_ladder request {i}: rungs at {temps}")
        greedy_tokens = rungs[id(reqs[i])][0][1]
        check(all(tk != greedy_tokens for _, tk in rungs[id(reqs[i])][1:]),
              f"stt_ladder request {i}: a sampled rung gave the greedy tokens "
              f"{greedy_tokens}")

    # beam_decode in fp32 against a greedy loop, on one encoded utterance
    dec = cast_floating(dec, torch.float32)
    enc = eng._encode(reqs[0]).float()
    prompt, _ = eng._build_prompt(stt.STTRequest(audio=audios[0], text_cb=None))
    P = len(prompt)

    def decode(force=None):
        """Greedy (``force`` None) or teacher-forced (``force``, then EOS)
        decode after the prompt on a fresh cache: the tokens and their sum
        logprob, EOS's included."""
        cache = wsp.fill_cross_kv(dec, cfg, wsp.init_cache(
            cfg, 1, P + LADDER_NEW, enc.shape[1], "cuda"), enc)
        for i, tok in enumerate(prompt):
            logits = wsp.decode_step(dec, cfg, torch.tensor([tok], device="cuda"), cache,
                                     torch.tensor([i], device="cuda"))
        out, total = [], 0.0
        for t in range(LADDER_NEW):
            if force is None:
                nxt = int(torch.argmax(logits[0]))
            else:
                nxt = force[t] if t < len(force) else cfg.eos_token_id
            total += float(torch.log_softmax(logits[0].float(), -1)[nxt])
            if nxt == cfg.eos_token_id:
                break
            out.append(nxt)
            logits = wsp.decode_step(dec, cfg, torch.tensor([nxt], device="cuda"), cache,
                                     torch.tensor([P + t], device="cuda"))
        return out, total

    with torch.no_grad():
        t0 = time.perf_counter()
        greedy, greedy_lp = decode()
        greedy_s = time.perf_counter() - t0
        beams = {}
        for W in (1, LADDER_BEAM):
            t0 = time.perf_counter()
            tk, ng, lp = wsp.beam_decode(dec, cfg, enc, prompt, P, beam_size=W,
                                         max_new=LADDER_NEW, eos_id=cfg.eos_token_id)
            beams[W] = ([int(x) for x in tk[: int(ng)].tolist()], float(lp),
                        time.perf_counter() - t0)
        rescored = {W: decode(b[0])[1] for W, b in beams.items()}
    emit("stt_ladder", model="whisper-large-v3", wall_s=wall_s, steps=steps,
         requests=n, encodes=encodes, encode_ms=eng.encode_ms[:encodes],
         attention_launches=launches, counters=grew,
         latency_s=[r.inf_time for r in res], n_tokens=[len(r.tokens) for r in res],
         avg_logprob=[r.avg_logprob for r in res],
         rung_tokens=[[tk[:6] for _, tk in rungs[id(r)]] for r in reqs],
         greedy_tokens=greedy, greedy_sum_logprob=greedy_lp,
         beam_tokens={str(W): b[0] for W, b in beams.items()},
         beam_sum_logprob={str(W): b[1] for W, b in beams.items()},
         beam_rescored_sum_logprob={str(W): v for W, v in rescored.items()},
         beam_s={str(W): b[2] for W, b in beams.items()}, greedy_loop_s=greedy_s)
    check(beams[1][0] == greedy, f"stt_ladder: beam W 1 {beams[1][0]} != greedy {greedy}")
    check(len(set(greedy)) > 1, f"stt_ladder: a degenerate decoder ({greedy})")
    for W, (tk, lp, _) in beams.items():  # the beams' own scores are their tokens'
        check(abs(lp - rescored[W]) <= 1e-4 * abs(rescored[W]),
              f"stt_ladder: beam W {W} scored {lp}, its tokens rescore to {rescored[W]}")
    check(beams[LADDER_BEAM][1] > beams[1][1],
          f"stt_ladder: beam W {LADDER_BEAM} sum logprob {beams[LADDER_BEAM][1]} not above "
          f"W 1's {beams[1][1]}")
    return launches


def phase_sttbench(torch):
    """Phase ``sttbench``: ``python -m infernos_tpu_torch.bench.sttbench
    --full --slots 16 --max-new 24 --n 16`` (whisper-large-v3, seeded random
    bf16 weights, which never emit EOS, hence the cap).  Checks: 16
    utterances come back, one encode each after the engine's warm-up;
    kernel 1 launches 32 times per encode, kernel 2 never.  Prints the
    realtime factor and the latency p50/p95.  Returns the kernel-1
    launches."""
    from infernos_tpu_torch.utils.platform import card_info

    r = run_bench("sttbench", "infernos_tpu_torch.bench.sttbench",
                  ["--full", "--slots", "16", "--max-new", "24", "--n", "16"], timeout=300)
    check(r.rc == 0 and r.lines, f"sttbench: the bench exited {r.rc}")
    res = r.lines[-1]
    calls = bench_launches(r, "sttbench", tts=False)
    emit("sttbench", card=card_info(), seconds=r.seconds, result=res, launches=calls)
    check(res["utterances"] == 16 and calls["encodes"] == 16,
          f"sttbench: {res['utterances']} of 16 utterances, {calls['encodes']} encodes")
    check(r.work["done"]["encoder_layers"] == [32],
          f"sttbench: encoder layers {r.work['done']['encoder_layers']}")
    return calls["kernel1"]


def phase_ttsbench(torch):
    """Phase ``ttsbench``: ``python -m infernos_tpu_torch.bench.ttsbench 16
    --full --max-frames 128`` (SpeechT5 + HiFi-GAN at full width, seeded
    random bf16 weights, 8 slots).  Checks: 16 reports, each with frames;
    kernel 2 (bf16) launches once per step.  Prints first-frame p50/p95 and
    the real-time ratio's mean and minimum.  Returns the bf16 launches."""
    from infernos_tpu_torch.utils.platform import card_info

    r = run_bench("ttsbench", "infernos_tpu_torch.bench.ttsbench",
                  ["16", "--full", "--max-frames", "128"], timeout=300)
    check(r.rc == 0 and r.lines, f"ttsbench: the bench exited {r.rc}")
    res = r.lines[-1]
    calls = bench_launches(r, "ttsbench", stt=False)
    emit("ttsbench", card=card_info(), seconds=r.seconds, result=res, launches=calls)
    check(res["sessions"] == 16 and len(res["frames"]) == 16 and min(res["frames"]) > 0,
          f"ttsbench: {res['sessions']} reports, frames {res['frames']}")
    return calls["kernel2"]


def phase_ttsprobe(torch):
    """Phase ``ttsprobe``: ``python -m infernos_tpu_torch.bench.ttsprobe
    --slots 24 --ticks 60 --frames 96`` (full width, zero weights, bf16):
    the tick time of the kernel path.  Checks: its line, kernel 2 (bf16)
    once per step over its whole run (it has no warm-up: its first tick,
    timed apart, is part of the probe).  Returns the bf16 launches."""
    from infernos_tpu_torch.utils.platform import card_info

    r = run_bench("ttsprobe", "infernos_tpu_torch.bench.ttsprobe",
                  ["--slots", "24", "--ticks", "60", "--frames", "96"], timeout=300)
    check(r.rc == 0 and r.lines, f"ttsprobe: the bench exited {r.rc}")
    res = r.lines[-1]["fused"]
    calls = bench_launches(r, "ttsprobe", stt=False)
    emit("ttsprobe", card=card_info(), seconds=r.seconds, result=res, launches=calls)
    check(0 < res["tick_p50_ms"] <= res["tick_p95_ms"], f"ttsprobe: {res}")
    return calls["kernel2"]


LLM_BENCH_ARGS = ["--dims", "7b", "--slots", "8", "--new", "48", "--reqs", "16",
                  "--prompt", "256"]


def phase_llmbench(torch):
    """Phase ``llmbench``: ``python -m infernos_tpu_torch.bench.llmbench
    --dims 7b --slots 8 --new 48 --reqs 16 --prompt 256`` (Qwen2.5-7B dims
    in the int8 layout, bf16), then the same with ``--spec``.  Checks:
    every request finishes with its 48 tokens; no kernel of this port
    launches (the LLM runs none).  Prints tokens/s, generation p50/p95 and
    the speculative emit mean of each mode."""
    from infernos_tpu_torch.utils.platform import card_info

    torch.cuda.empty_cache()
    out = {}
    for mode, extra in (("k8", []), ("spec", ["--spec"])):
        r = run_bench(f"llmbench_{mode}", "infernos_tpu_torch.bench.llmbench",
                      LLM_BENCH_ARGS + extra, timeout=300)
        check(r.rc == 0 and r.lines, f"llmbench {mode}: the bench exited {r.rc}")
        res = r.lines[-1]
        d = res["detail"]
        check(d["finished"] == 16 and d["tokens"] == 16 * 48,
              f"llmbench {mode}: {d['finished']} finished, {d['tokens']} tokens")
        check(all(r.work["done"][k] == 0 for k in LAUNCH_KEYS),
              f"llmbench {mode}: a port kernel launched: {r.work['done']}")
        out[mode] = {"seconds": r.seconds, "llm_decode_tok_per_s": res["value"],
                     "unit": res["unit"], **d}
    emit("llmbench", card=card_info(), **out)


# -- phase parallel: the dry run and Qwen tensor parallelism over ranks -------

TP_RANKS = 4
TP_LAYERS = 4  # of Qwen2.5-14B's 48: full width, depth cut to fit the phase's time
TP_SEED = 14
TP_PROMPTS = (64, 128)  # prompt tokens of the two requests, one bucket each
TP_NEW = 16
# relative L2 error of a logits row, tp 4 against unsharded (bf16
# activations, int8 weights).  Set at 2e-2 before the first run, which read
# 2.11e-2 to 2.33e-2 on every row, prefills and decode steps alike: an even
# level, not a drift.  It is the bf16 path's own rounding at this width:
# against fp32 activations on the same int8 tree the unsharded run's
# prefill rows are 3.46e-2 and 3.95e-2 off, the tp run's 3.44e-2 and
# 4.13e-2 (the second run).  So the bound is that floor, and the tp run
# must also be no further from fp32 than TP_FP32_RATIO times the
# unsharded run's distance, row by row.
TP_REL_TOL = 4e-2
TP_FP32_RATIO = 1.25
TP_TIMED = 5  # eager decode dispatches timed per rank
HF_QWEN_STD = 0.02  # HF Qwen2Config.initializer_range


def qwen14b_cfg():
    import dataclasses

    from infernos_tpu_torch.models import presets

    return dataclasses.replace(presets.QWEN25_14B, num_layers=TP_LAYERS)


def qwen14b_tree(torch, cfg, device):
    """Qwen2.5-14B's tree at ``cfg``'s depth at HF's init (linears and
    embeddings N(0, 0.02), zero biases, RMSNorm gains 1), bf16, drawn on
    ``device`` from ``TP_SEED`` (the same values in every process on one
    kind of card), then quantized whole by ``quantize_params``."""
    from infernos_tpu_torch.models import qwen, quant

    g = torch.Generator(device=device).manual_seed(TP_SEED)

    def make(path, x):
        if path[-1] == "g":
            return torch.ones(x.shape, dtype=x.dtype, device=device)
        if path[-1] == "b":
            return torch.zeros(x.shape, dtype=x.dtype, device=device)
        t = torch.empty(x.shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, HF_QWEN_STD, generator=g).to(x.dtype)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return make(path, node)

    shapes = qwen.init_params(cfg, None, "meta", torch.bfloat16)
    return quant.quantize_params(walk(shapes, ()))


def tp_budget(torch, cfg, full, specs, t: int) -> dict:
    """Per-rank bytes of ``full`` under ``specs`` at tp ``t``, its 2-slot
    bf16 KV cache and its largest prefill (K/V and activations), as the
    budget tests count them."""
    from infernos_tpu_torch.models import qwen
    from infernos_tpu_torch.parallel.budget import per_chip_bytes

    axis = {"tp": t}
    total = max(TP_PROMPTS) + TP_NEW + 16
    return {"weights_int8": per_chip_bytes(full, specs, axis),
            "kv_cache_bf16": per_chip_bytes(
                qwen.init_cache(cfg, 2, total, torch.bfloat16, "meta"),
                qwen.cache_shardings(cfg), axis),
            "prefill_kv_bf16": per_chip_bytes(
                qwen.init_cache(cfg, 1, max(TP_PROMPTS), torch.bfloat16, "meta"),
                qwen.cache_shardings(cfg), axis),
            "prefill_act_bf16": max(TP_PROMPTS) * cfg.hidden_size * 2 * 4}


def tp_prompts(cfg):
    rng = np.random.default_rng(TP_SEED)
    return [rng.integers(0, cfg.vocab_size, size=n) for n in TP_PROMPTS]


class LogitsRecord:
    """Wraps ``qwen.prefill`` and ``qwen.decode_step``: keeps each call's
    last-position logits (prefill) or logits (decode step) on the host with
    the step's input tokens, positions and write mask; with ``feed`` (an
    earlier record) each decode step takes that record's input tokens in
    place of its own, so both runs see the same inputs."""

    def __init__(self, torch, qwen, feed=None):
        self.torch, self.qwen, self.feed = torch, qwen, feed
        self.prefill, self.steps = [], []
        self._prefill, self._decode = qwen.prefill, qwen.decode_step

    def __enter__(self):
        torch, rec = self.torch, self

        def prefill(*a, **kw):
            out = rec._prefill(*a, **kw)
            rec.prefill.append(out[0][:, -1].float().cpu())
            return out

        def decode_step(params, cfg, tokens, cache, pos, write=None, **kw):
            if rec.feed is not None:
                tokens = torch.as_tensor(rec.feed[len(rec.steps)]["tokens"],
                                         device=tokens.device)
            logits, cache = rec._decode(params, cfg, tokens, cache, pos, write, **kw)
            rec.steps.append({"tokens": tokens.cpu(), "pos": pos.cpu(),
                              "write": write.cpu(), "logits": logits.float().cpu()})
            return logits, cache

        self._patch = mock.patch.multiple(self.qwen, prefill=prefill, decode_step=decode_step)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)


def tp_engine_ecfg(torch):
    from infernos_tpu_torch.serving.llm_engine import LLMEngineConfig

    return LLMEngineConfig(batch_slots=2, prompt_buckets=TP_PROMPTS,
                           max_total_tokens=max(TP_PROMPTS) + TP_NEW + 16,
                           max_new_tokens=TP_NEW, dtype=torch.bfloat16)


def serve_tp(eng, prompts) -> list:
    """``prompts`` through ``eng`` to the end: each request's token ids."""
    from infernos_tpu_torch.serving.llm_engine import LLMRequest

    reqs = [LLMRequest(p, lambda s, fin: None) for p in prompts]
    for r in reqs:
        eng.submit(r)
    streams = {}
    while True:
        for s in eng.slots:
            if s is not None:
                streams[id(s.req)] = s.streamer.tokens
        if not eng.step():
            break
    return [list(streams[id(r)]) for r in reqs]


def timed_steps(torch, eng, n: int) -> list:
    """ms of ``n`` eager decode dispatches of ``eng``, each synchronised."""
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    ms = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        eng._step()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def tp14b_rank(cfg, record: bool, device=None) -> dict:
    """One rank of ``tp_14b`` (and of ``nccl_1``): the whole int8 tree of
    ``cfg`` made here, cut to this rank's shards, an ``LLMEngine(mesh=...)``
    serving the two prompts; returns the tokens, the logits record
    (``record``), the rank's parameter bytes beside the budget's, its peak
    memory and the ms of ``TP_TIMED`` eager decode dispatches.
    ``device="cpu"`` runs it on the CPU (``tests/test_torch_parallel_phase.py``
    at tiny dims)."""
    import torch

    from infernos_tpu_torch.models import qwen, quant
    from infernos_tpu_torch.parallel import make_mesh
    from infernos_tpu_torch.parallel.mesh import shard
    from infernos_tpu_torch.serving.llm_engine import LLMEngine

    mesh = make_mesh(axes=("tp",), device=device)
    cuda = mesh.device.type == "cuda"
    full = qwen14b_tree(torch, cfg, mesh.device)
    specs = quant.quantize_shardings(qwen.param_shardings(cfg), full)
    parts = tp_budget(torch, cfg, full, specs, mesh.size)
    params = shard(full, specs, mesh)
    del full
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng = LLMEngine(params, cfg, tp_engine_ecfg(torch), mesh=mesh)
    with LogitsRecord(torch, qwen) as rec:
        tokens = serve_tp(eng, tp_prompts(cfg))
    # every rank steps alike: the sums need all of them
    ms = timed_steps(torch, eng, TP_TIMED)
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend,
           "tokens": tokens, "param_bytes": quant.quantized_bytes(params),
           "budget": parts,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "dispatch_ms": ms, "cache": tuple(eng.cache.k.shape),
           "modules": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "infernos_tpu"))}
    if record and mesh.rank == 0:
        out["prefill"], out["steps"] = rec.prefill, rec.steps
    if mesh.backend == "gloo" and cuda:
        out["gloo_all_gather_cuda"] = gloo_all_gather_probe(torch, mesh)
    return out


def gloo_all_gather_probe(torch, mesh) -> str:
    """Whether gloo's ``all_gather`` takes CUDA tensors on this install
    (the port gathers by a sum into a zeroed buffer either way): "works",
    or the error it raised.  Every rank makes the same call."""
    import torch.distributed as dist

    x = torch.full((4,), float(mesh.rank), device=mesh.device)
    got = [torch.empty_like(x) for _ in range(mesh.size)]
    try:
        dist.all_gather(got, x)
    except (RuntimeError, ValueError) as e:
        return f"refused: {e}"[:200]
    ok = all(bool((t == r).all()) for r, t in enumerate(got))
    return "works" if ok else "wrong values"


def rel_l2(torch, got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def tp_run(torch, cfg, n: int, device=None) -> dict:
    """``tp_14b`` and ``nccl_1`` on ``cfg``: ``n`` ranks of
    :func:`tp14b_rank`, then one rank alone (NCCL on the card), then the
    unsharded engine on the same tree in this process, plain greedy and
    again fed the tp run's decode inputs.  Returns the runs, each logits
    row's relative L2 error (tp against unsharded, same inputs) and the
    greedy tokens that agree."""
    from infernos_tpu_torch.models import qwen
    from infernos_tpu_torch.parallel.ranks import run_ranks
    from infernos_tpu_torch.serving.llm_engine import LLMEngine

    dev = torch.device(device or "cuda")
    t0 = time.monotonic()
    tp = run_ranks(tp14b_rank, n, (cfg, True, device), device=device)
    tp_s = time.monotonic() - t0
    t0 = time.monotonic()
    one = run_ranks(tp14b_rank, 1, (cfg, False, device), device=device)[0]
    one_s = time.monotonic() - t0
    t0 = time.monotonic()
    full = qwen14b_tree(torch, cfg, dev)
    prompts = tp_prompts(cfg)
    plain = serve_tp(LLMEngine(full, cfg, tp_engine_ecfg(torch), device=dev), prompts)
    eng = LLMEngine(full, cfg, tp_engine_ecfg(torch), device=dev)
    with LogitsRecord(torch, qwen, feed=tp[0]["steps"]) as ref:
        serve_tp(eng, prompts)
    ms_plain = timed_steps(torch, eng, TP_TIMED)
    # the noise floor: both bf16 runs against fp32 activations on the same
    # int8 tree, at the prefills' last positions
    from infernos_tpu_torch.models.convert import cast_floating

    f32 = cast_floating(full, torch.float32)
    exact = [qwen.prefill(f32, cfg, torch.as_tensor(p, device=dev)[None])[0][:, -1].float().cpu()
             for p in prompts]
    del f32
    vs_fp32 = {"unsharded_bf16": [rel_l2(torch, a, b) for a, b in zip(ref.prefill, exact)],
               f"tp{n}_bf16": [rel_l2(torch, a, b) for a, b in zip(tp[0]["prefill"], exact)]}
    ref_s = time.monotonic() - t0
    check(len(ref.steps) == len(tp[0]["steps"]) and len(ref.prefill) == len(TP_PROMPTS),
          f"tp_14b: {len(ref.steps)} unsharded decode steps against "
          f"{len(tp[0]['steps'])} at tp {n}")
    errs, agree, total = [], 0, 0
    for a, b in zip(tp[0]["prefill"], ref.prefill):
        errs.append(rel_l2(torch, a, b))
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        total += a.shape[0]
    for a, b in zip(tp[0]["steps"], ref.steps):
        check(bool((a["pos"] == b["pos"]).all() and (a["write"] == b["write"]).all()),
              "tp_14b: the replayed unsharded run left the tp run's positions")
        live = a["write"]
        if bool(live.any()):
            errs.append(rel_l2(torch, a["logits"][live], b["logits"][live]))
            agree += int((a["logits"][live].argmax(-1) == b["logits"][live].argmax(-1)).sum())
            total += int(live.sum())
    return {"tp": tp, "one": one, "plain": plain, "errs": errs, "agree": agree,
            "total": total, "vs_fp32": vs_fp32, "ms_plain": ms_plain, "tp_s": tp_s,
            "one_s": one_s, "ref_s": ref_s}


def tp_checks(cfg, n: int, run: dict) -> None:
    """What ``tp_14b`` and ``nccl_1`` hold of :func:`tp_run`'s result."""
    tp, one = run["tp"], run["one"]
    check(max(run["errs"]) <= TP_REL_TOL,
          f"tp_14b: logits rel L2 {max(run['errs'])} > {TP_REL_TOL}")
    for t, u in zip(run["vs_fp32"][f"tp{n}_bf16"], run["vs_fp32"]["unsharded_bf16"]):
        check(t <= TP_FP32_RATIO * u,
              f"tp_14b: tp logits against fp32 {t} > {TP_FP32_RATIO} x the "
              f"unsharded run's {u}")
    for r in tp:
        check(r["backend"] == "gloo", f"tp_14b: rank {r['rank']} over {r['backend']}")
        check(r["param_bytes"] == r["budget"]["weights_int8"],
              f"tp_14b: rank {r['rank']} holds {r['param_bytes']} parameter bytes, "
              f"the budget says {r['budget']['weights_int8']}")
        check(r["cache"][2] == cfg.num_kv_heads // n,
              f"tp_14b: rank {r['rank']} cache {r['cache']}")
        check(not r["modules"], f"tp_14b: rank {r['rank']} loaded {r['modules']}")
        check(r["tokens"] == tp[0]["tokens"], "tp_14b: the ranks took different tokens")
    check(one["tokens"] == run["plain"],
          f"nccl_1: tokens {one['tokens']} != unsharded {run['plain']}")
    check(one["param_bytes"] == one["budget"]["weights_int8"],
          f"nccl_1: {one['param_bytes']} parameter bytes, budget "
          f"{one['budget']['weights_int8']}")


def phase_parallel(torch) -> dict:
    """Phase ``parallel``: the parallel plane over rank processes on the card.

    ``dryrun``: ``dryrun_multichip(2)`` (two ranks on the card over gloo):
    the TTS and STT engines of each rank launch kernel 2 and kernel 1 in
    that rank's process (counted there, each above 0), the LLM runs under
    tp 2, and no rank loads ``jax`` or the reference package.
    ``tp_14b``: Qwen2.5-14B at full width, ``TP_LAYERS`` layers, HF's init
    in bf16 quantized whole to int8, over ``TP_RANKS`` ranks on the card
    (gloo): each rank's engine serves prompts of 64 and 128 tokens for 16
    new tokens; each logits row (the prefills' last positions, every decode
    step's, on the same inputs) within ``TP_REL_TOL`` relative L2 of the
    unsharded engine on the same tree here, and the prefill rows no further
    from fp32 activations on that tree than ``TP_FP32_RATIO`` times the
    unsharded rows are; each rank's parameter bytes
    equal to the budget's ``per_chip_bytes``, byte for byte.  ``nccl_1``:
    the same engine code at tp 1 in a one-rank NCCL group: its tokens equal
    the unsharded engine's.  Prints the backend and device of each rank,
    the budget's parts beside each rank's peak memory and the card's
    memory, and one eager decode dispatch at tp 4 and tp 1 (no speed figure:
    four ranks time-share one card and their sums go through the host).
    Returns the dry run's kernel launches by rank."""
    from infernos_tpu_torch.parallel.budget import budget_report
    from infernos_tpu_torch.parallel.dryrun import dryrun_multichip
    from infernos_tpu_torch.utils.platform import card_info

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    res = dryrun_multichip(2)
    dry_s = time.monotonic() - t0
    emit("parallel_dryrun", seconds=dry_s, card=card_info(),
         ranks=[{k: r[k] for k in ("rank", "device", "backend", "launches", "modules")}
                for r in res])
    for r in res:
        check(r["backend"] == "gloo" and r["device"] == "cuda:0",
              f"dryrun: rank {r['rank']} on {r['device']} over {r['backend']}")
        # the dry run's engines are fp32, as the reference's: the fp32 modes alone
        tts_steps = path_launches(r["launches"]["tts"], "dryrun tts", fp32=True)[1]
        stt_attn = path_launches(r["launches"]["stt"], "dryrun stt", fp32=True)[0]
        check(tts_steps > 0 and stt_attn > 0,
              f"dryrun: rank {r['rank']} launched {r['launches']}")
        check(not r["modules"], f"dryrun: rank {r['rank']} loaded {r['modules']}")

    cfg = qwen14b_cfg()
    run = tp_run(torch, cfg, TP_RANKS)
    tp, one = run["tp"], run["one"]
    total_mem = torch.cuda.get_device_properties(0).total_memory
    parts = tp[0]["budget"]
    emit("parallel_tp_14b", seconds=run["tp_s"], reference_s=run["ref_s"], card=card_info(),
         layers=f"{TP_LAYERS} of 48",
         ranks=[{"rank": r["rank"], "device": r["device"], "backend": r["backend"],
                 "param_bytes": r["param_bytes"],
                 "budget_weights": r["budget"]["weights_int8"],
                 "peak_bytes": r["peak_bytes"], "cache": r["cache"]} for r in tp],
         budget_parts=parts, budget=budget_report(parts, limit=total_mem),
         card_total_memory=total_mem,
         max_rel_l2=max(run["errs"]), rel_l2=run["errs"], rel_tol=TP_REL_TOL,
         prefill_rel_l2_vs_fp32=run["vs_fp32"],
         greedy_agree=f"{run['agree']} of {run['total']}",
         tp_tokens=tp[0]["tokens"], unsharded_tokens=run["plain"],
         gloo_all_gather_cuda=tp[0].get("gloo_all_gather_cuda"),
         decode_dispatch_ms={f"tp{TP_RANKS}_gloo_shared_card": tp[0]["dispatch_ms"],
                             "tp1_nccl": one["dispatch_ms"], "unsharded": run["ms_plain"],
                             "note": f"no speed figure: {TP_RANKS} ranks time-share one "
                                     "card and their sums go through the host"})
    emit("parallel_nccl_1", seconds=run["one_s"], backend=one["backend"],
         device=one["device"], tokens_equal=one["tokens"] == run["plain"],
         param_bytes=one["param_bytes"], budget_weights=one["budget"]["weights_int8"],
         peak_bytes=one["peak_bytes"])
    check(one["backend"] == "nccl", f"nccl_1: backend {one['backend']}")
    tp_checks(cfg, TP_RANKS, run)
    torch.cuda.empty_cache()
    emit("parallel", seconds=time.monotonic() - t_phase, dryrun_s=dry_s,
         tp_14b_s=run["tp_s"], nccl_1_s=run["one_s"], reference_s=run["ref_s"])
    return {f"dryrun_rank{r['rank']}": r["launches"] for r in res}

AIA_SILENT_TURNS = 2  # the most turns the tiny LLM may leave unanswered on the card


def aia_turns(log: str) -> list:
    """The attendant sessions' turns from their DEBUG log: ``(heard, replies)``
    per turn, the STT texts since the session's last reply and the LLM
    replies to them, in order."""
    import re

    by_session = {}
    for m in re.finditer(r"AIASession (\S+): (stt|llm) (.*)", log):
        sid, kind, text = m.groups()
        turns = by_session.setdefault(sid, [])
        if kind == "stt":
            if not turns or turns[-1][1]:
                turns.append(([], []))
            turns[-1][0].append(text)
        elif turns:
            turns[-1][1].append(text)
    return [t for turns in by_session.values() for t in turns]


def phase_aia_bench(torch):
    """Phase ``aia_bench``: ``python -m infernos_tpu_torch.bench.aiabench
    --tiny-real --calls 2 --turns 2 --turn-timeout 10``: two attendant
    calls over SIP on the trained tiny trio (fp32), the sessions' DEBUG log
    on (a reply takes about 2.6 s; a turn the LLM leaves unanswered waits
    10 s, not the default 90).  Checks: 2 answered; of the 4 turns, at most
    ``AIA_SILENT_TURNS`` (2) failed, each one the tiny LLM answered with
    ``<nothingtosay>``, and the others measured a reply.  How many depends
    on what the tiny STT hears, which the VAD's cuts of the paced RTP
    stream move from run to run: "what is my order tatus" (silent) or
    "... status" (answered); 1 in fp32 on the CPU, in the port and in the
    reference package alike.  (The card's bf16 runs also left "can me
    speak with meu" unanswered, which fp32 on the CPU answers; those turns
    are printed.)  Also the calls' launches in the fp32 modes (kernel 1 =
    2 x encodes, kernel 2 = steps).  Prints the reply latency p50/p95, the
    STT texts and the LLM replies.  Returns (kernel 1, kernel 2) launches."""
    from infernos_tpu_torch.utils.platform import card_info

    r = run_bench("aia_bench", "infernos_tpu_torch.bench.aiabench",
                  ["--tiny-real", "--calls", "2", "--turns", "2", "--turn-timeout", "10"],
                  timeout=300, env_extra={"INFERNOS_LOG_LEVEL": "DEBUG"})
    res = r.lines[-1] if r.lines else {}
    heard = [ln.split(": stt ", 1)[1] for ln in r.err.splitlines() if ": stt " in ln]
    replies = [ln.split(": llm ", 1)[1] for ln in r.err.splitlines() if ": llm " in ln]
    silent = sum(rep.startswith("'<nothingtosay>'") for rep in replies)
    turns = aia_turns(r.err)
    speak = [t for t in turns if any("speak with" in h for h in t[0])]
    calls = bench_launches(r, "aia_bench", fp32=True) if r.rc == 0 else None
    emit("aia_bench", card=card_info(), seconds=r.seconds, exit_code=r.rc, result=res,
         stt=heard, llm=replies, speak_with_turns=speak, launches=calls)
    check(r.rc == 0, f"aia_bench: aiabench exited {r.rc}")
    check(res.get("answered") == 2 and res["turns"] == 4 - silent,
          f"aia_bench: want 2 answered and {4 - silent} turns measured: {res}")
    check(res["failures"] == silent and silent <= AIA_SILENT_TURNS,
          f"aia_bench: {res['failures']} failed turns, {silent} silent replies, want "
          f"each failure silent, at most {AIA_SILENT_TURNS}: {replies}")
    return calls["kernel1"], calls["kernel2"]


def phase_echo(torch):
    """Phase ``echo``: ``python -m infernos_tpu_torch.bench.echo --tiny-real
    --utterances 2``: one RTP leg through VAD, the tiny-real STT and TTS
    actors and back (no SIP).  Checks: an echo latency and an STT latency
    per utterance, echoed audio received; the launches after the actors'
    warm-ups.  Returns (attention, bf16 step) launches."""
    from infernos_tpu_torch.utils.platform import card_info

    r = run_bench("echo", "infernos_tpu_torch.bench.echo",
                  ["--tiny-real", "--utterances", "2"], timeout=300)
    res = r.lines[-1] if r.lines else {}
    calls = bench_launches(r, "echo", fp32=True) if r.rc == 0 else None
    emit("echo", card=card_info(), seconds=r.seconds, exit_code=r.rc, result=res,
         launches=calls)
    check(r.rc == 0, f"echo: the bench exited {r.rc}")
    check(len(res.get("echo_latency_s", [])) == 2 and len(res.get("stt_latency_s", [])) == 2,
          f"echo: want an echo and an STT latency per utterance: {res}")
    check(res["rx_audio_s"] > 0, f"echo: no echoed audio: {res}")
    return calls["kernel1"], calls["kernel2"]


RAMP_PROFILE_HZ = "200"
# a turn SLA no turn reaches: the profiled level runs once, not again on a
# miss as lt_ramp's does (that retry measures the ramp, not the host)
RAMP_PROFILE_SLA_S = "600"
# one turn per call (lt_ramp runs two), to make room for remote_call: the
# level's two calls are the same, profiled over one turn each (on an H100:
# the phase 69.6 s and its level 32.3 s at two turns; 35.4-48.2 s and
# 4.9-6.3 s at one; PERF.md §6)
RAMP_PROFILE_TURNS = "1"


def phase_ramp_profile(torch):
    """Phase ``ramp_profile``: ``ltbench --ramp --full --turns 1 --levels
    2 --sla 600`` (as ``lt_ramp`` runs it, but the level runs once, one
    turn per call) with
    ``INFERNOS_PYSAMPLER`` set: the host profile of a two-call level.
    Checks: one level, both calls answered; the dump exists and holds
    samples from the level only (the sampler is reset before the ladder:
    its sampled time is within the levels' wall time, and no sampled stack
    is a warm-up's); the launches as ``lt_ramp``'s.  Prints the level's turn
    p95, the on-CPU share, the top 10 on-CPU and waiting leaves and the
    on-CPU threads.  Returns (attention, bf16 step) launches."""
    import tempfile

    from infernos_tpu_torch.utils.platform import card_info

    torch.cuda.empty_cache()
    dump = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_prof_"), "prof.json")
    r = run_bench("ramp_profile", "infernos_tpu_torch.bench.ltbench",
                  ["--ramp", "--full", "--turns", RAMP_PROFILE_TURNS, "--levels", "2",
                   "--sla", RAMP_PROFILE_SLA_S], timeout=600,
                  env_extra={**LT_RAMP_ENV, "INFERNOS_PYSAMPLER": dump,
                             "INFERNOS_PYSAMPLER_HZ": RAMP_PROFILE_HZ})
    ramp = [ln for ln in r.lines if ln.get("metric") == "lt_calls_per_chip"]
    levels = ramp[-1].get("detail", {}).get("levels", []) if ramp else []
    calls = bench_launches(r, "ramp_profile") if r.rc == 0 else None
    check(r.rc == 0, f"ramp_profile: ltbench exited {r.rc}")
    check(os.path.exists(dump), "ramp_profile: the sampler left no dump")
    with open(dump) as f:
        prof = json.load(f)
    on = sum(n for _, n in prof["on_cpu_leaves"])
    wait = sum(n for _, n in prof["waiting_leaves"])
    sampled_s = prof["n_samples"] * prof["interval_s"]
    levels_s = sum(lv["wall_s"] for lv in levels)
    emit("ramp_profile", card=card_info(), seconds=r.seconds, levels=levels,
         turn_p95_s=[lv["turn_p95_s"] for lv in levels], n_samples=prof["n_samples"],
         interval_s=prof["interval_s"], sampled_s=sampled_s, levels_wall_s=levels_s,
         on_cpu_share_top40=on / max(1, on + wait),
         on_cpu_leaves=prof["on_cpu_leaves"][:10], waiting_leaves=prof["waiting_leaves"][:10],
         on_cpu_threads=prof["on_cpu_threads"][:10], on_cpu_stacks=prof["on_cpu_stacks"][:10],
         launches=calls)
    check(len(levels) == 1 and levels[0]["n_calls"] == 2 and levels[0]["answered"] == 2,
          f"ramp_profile: want one level that answered its two calls: {levels}")
    check(prof["n_samples"] > 0 and on > 0, f"ramp_profile: {prof['n_samples']} samples")
    check(sampled_s <= levels_s + 5.0,
          f"ramp_profile: {sampled_s:.1f} s sampled over {levels_s:.1f} s of levels")
    check(not any("warmup" in k or "build_cluster" in k for k, _ in prof["on_cpu_stacks"]),
          "ramp_profile: the dump holds the boot's stacks")
    return calls["kernel1"], calls["kernel2"]


# -- phase 28: HF-layout weights through port_from_hf, a checkpoint and the
# actors --------------------------------------------------------------------

# the HF-layout weights' generator.  Many draws at HF's init give a Whisper
# decoder that emits one token for the whole decode (the residual stream
# outweighs the token embedding), which would leave the distinct-token guard
# nothing to hold; this seed's draw decodes the utterance into several
# (``--ckpt-seed`` runs the phase at another draw)
CKPT_SEED = 13
CKPT_UTTER_S = 5.0  # one utterance through the STT actor
CKPT_TTS_STEPS = 64  # TTSEngineConfig.max_steps: random weights never stop
# the engine keeps the cross K/V in int8 (per-position scales) and computes
# in bf16, decode_full in fp32 from the same bf16 weights: a token is held to
# decode_full's argmax only where its top-2 logit margin exceeds CKPT_MARGIN,
# and each step's chosen-token logprob must agree within CKPT_LOGPROB_TOL
# (the card read 0.01975 nats at this seed, 0.0174-0.0385 over seeds 10-19)
CKPT_MARGIN = 0.1
CKPT_LOGPROB_TOL = 0.05
# relative L2 error of the step kernel's hidden states (bf16 weights and
# caches, fp32 hidden) against decode_full in fp32 over the same inputs (the
# card read 0.301-0.321% over seeds 10-19)
CKPT_DEC_REL_TOL = 1e-2
# the int8 checkpoint's step hidden states against decode_full in fp32 of the
# same int8 tree dequantized (codes times fp32 scales, every other leaf as the
# engine serves it): the codes are exact in bf16 and the kernel scales its fp32
# sums by the fp32 scales, so its errors are the bf16 path's (activations and
# caches rounded to bf16), plus the cross K/V projections' scales rounded to
# bf16 in ``layers.linear`` (2^-9 relative at most), inside that bound's margin
CKPT_INT8_DEC_REL_TOL = CKPT_DEC_REL_TOL
# relative L2 error of the engine's encoder output (kernel 1, bf16
# activations) against the plain encode in fp32 on the same loaded weights
# (the card read 1.378-1.445% over seeds 10-19)
CKPT_ENC_REL_TOL = 2e-2
# the faults read against each agreement check, in the first layer's
# attention output projection (the encoder's self-attention, the decoders'
# cross-attention): its first head's input rows zeroed, which the encoder and
# TTS checks must see (the card read 9.6-12.2% and 5.5-7.9% over seeds
# 10-19; the STT logprobs moved 0.049-0.258 nats, not always past the
# bound), and all of them, the layer's attention dropped, which every check
# must see
CKPT_FAULTS = ("head", "layer")


def hf_whisper_config(cfg):
    """``(config, generation_config)`` stand-ins with HF Whisper's field names."""
    hc = types.SimpleNamespace(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.num_mel_bins, d_model=cfg.d_model,
        encoder_layers=cfg.encoder_layers, encoder_attention_heads=cfg.encoder_attention_heads,
        decoder_layers=cfg.decoder_layers, decoder_attention_heads=cfg.decoder_attention_heads,
        encoder_ffn_dim=cfg.ffn_dim, decoder_ffn_dim=cfg.ffn_dim,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions, eos_token_id=cfg.eos_token_id,
        decoder_start_token_id=cfg.sot_token_id)
    return hc, types.SimpleNamespace(decoder_start_token_id=cfg.sot_token_id)


def hf_speecht5_config(cfg):
    """A stand-in with HF ``SpeechT5Config``'s field names."""
    names = ("vocab_size", "hidden_size", "encoder_layers", "encoder_attention_heads",
             "encoder_ffn_dim", "decoder_layers", "decoder_attention_heads",
             "decoder_ffn_dim", "num_mel_bins", "reduction_factor",
             "speech_decoder_prenet_layers", "speech_decoder_prenet_units",
             "speech_decoder_prenet_dropout", "speech_decoder_postnet_layers",
             "speech_decoder_postnet_units", "speech_decoder_postnet_kernel",
             "speaker_embedding_dim", "max_text_positions", "max_speech_positions",
             "encoder_max_relative_position", "pad_token_id", "layer_norm_eps")
    return types.SimpleNamespace(**{n: getattr(cfg, n) for n in names})


def hf_hifigan_config(cfg):
    """A stand-in with HF ``SpeechT5HifiGanConfig``'s field names."""
    return types.SimpleNamespace(
        model_in_dim=cfg.model_in_dim, upsample_initial_channel=cfg.upsample_initial_channel,
        upsample_rates=list(cfg.upsample_rates),
        upsample_kernel_sizes=list(cfg.upsample_kernel_sizes),
        resblock_kernel_sizes=list(cfg.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(d) for d in cfg.resblock_dilation_sizes],
        leaky_relu_slope=cfg.leaky_relu_slope, normalize_before=cfg.normalize_before)


class HFLayout:
    """The rows of an HF state dict: ``(key, shape, init, path, layout)``.

    ``init`` is HF's: ``normal`` N(0, 0.02), ``zeros``, ``ones``, ``sin``
    (Whisper's encoder positions), ``count`` (an int64 counter); ``path``
    is where ``port_from_hf`` puts the tensor in the port's tree (a stacked
    layer's index last), None where it reads none; ``layout`` is ``T``
    (a linear, transposed), ``K`` (a conv, axes reversed) or ``""``."""

    def __init__(self):
        self.rows = []

    def add(self, key, shape, init, path, layout=""):
        self.rows.append((key, tuple(shape), init, path, layout))

    def lin(self, key, path, n_in, n_out, layer=None, bias=True):
        idx = () if layer is None else (layer,)
        self.add(f"{key}.weight", (n_out, n_in), "normal", path + ("w",) + idx, "T")
        if bias:
            self.add(f"{key}.bias", (n_out,), "zeros", path + ("b",) + idx)

    def ln(self, key, path, d, layer=None):
        idx = () if layer is None else (layer,)
        self.add(f"{key}.weight", (d,), "ones", path + ("g",) + idx)
        self.add(f"{key}.bias", (d,), "zeros", path + ("b",) + idx)

    def conv(self, key, path, shape, bias=True, transposed=False):
        """``Conv1d`` ``[C_out, C_in, K]``; ``ConvTranspose1d`` ``[C_in, C_out, K]``."""
        self.add(f"{key}.weight", shape, "normal", path + ("w",), "K")
        if bias:
            self.add(f"{key}.bias", (shape[1] if transposed else shape[0],), "zeros",
                     path + ("b",))

    def attn(self, key, path, d, layer, k_bias=True):
        for hf, ours in (("k_proj", "k"), ("v_proj", "v"), ("q_proj", "q"), ("out_proj", "o")):
            self.lin(f"{key}.{hf}", path + (ours,), d, d, layer, bias=hf != "k_proj" or k_bias)


def hf_whisper_layout(cfg) -> HFLayout:
    """HF ``WhisperForConditionalGeneration``'s state dict at ``cfg``'s dims."""
    lay, D, F = HFLayout(), cfg.d_model, cfg.ffn_dim
    enc, dec = "model.encoder", "model.decoder"
    lay.conv(f"{enc}.conv1", ("conv1",), (D, cfg.num_mel_bins, 3))
    lay.conv(f"{enc}.conv2", ("conv2",), (D, D, 3))
    lay.add(f"{enc}.embed_positions.weight", (cfg.max_source_positions, D), "sin", ("enc_pos",))
    for i in range(cfg.encoder_layers):
        p, q = f"{enc}.layers.{i}", ("enc_layers",)
        lay.attn(f"{p}.self_attn", q + ("attn",), D, i, k_bias=False)
        lay.ln(f"{p}.self_attn_layer_norm", q + ("ln1",), D, i)
        lay.lin(f"{p}.fc1", q + ("fc1",), D, F, i)
        lay.lin(f"{p}.fc2", q + ("fc2",), F, D, i)
        lay.ln(f"{p}.final_layer_norm", q + ("ln2",), D, i)
    lay.ln(f"{enc}.layer_norm", ("enc_ln",), D)
    lay.add(f"{dec}.embed_tokens.weight", (cfg.vocab_size, D), "normal", ("tok_embed", "w"))
    lay.add(f"{dec}.embed_positions.weight", (cfg.max_target_positions, D), "normal",
            ("dec_pos", "w"))
    for i in range(cfg.decoder_layers):
        p, q = f"{dec}.layers.{i}", ("dec_layers",)
        lay.attn(f"{p}.self_attn", q + ("self_attn",), D, i, k_bias=False)
        lay.ln(f"{p}.self_attn_layer_norm", q + ("ln1",), D, i)
        lay.attn(f"{p}.encoder_attn", q + ("cross_attn",), D, i, k_bias=False)
        lay.ln(f"{p}.encoder_attn_layer_norm", q + ("ln2",), D, i)
        lay.lin(f"{p}.fc1", q + ("fc1",), D, F, i)
        lay.lin(f"{p}.fc2", q + ("fc2",), F, D, i)
        lay.ln(f"{p}.final_layer_norm", q + ("ln3",), D, i)
    lay.ln(f"{dec}.layer_norm", ("dec_ln",), D)
    lay.add("proj_out.weight", (cfg.vocab_size, D), f"tied:{dec}.embed_tokens.weight", None)
    return lay


def hf_speecht5_layout(cfg) -> HFLayout:
    """HF ``SpeechT5ForTextToSpeech``'s state dict at ``cfg``'s dims."""
    lay, D, M = HFLayout(), cfg.hidden_size, cfg.num_mel_bins
    enc, dec, post = "speecht5.encoder", "speecht5.decoder", "speech_decoder_postnet"
    wenc, wdec = f"{enc}.wrapped_encoder", f"{dec}.wrapped_decoder"
    lay.add(f"{enc}.prenet.embed_tokens.weight", (cfg.vocab_size, D), "normal", ("text_embed", "w"))
    lay.add(f"{enc}.prenet.encode_positions.alpha", (), "ones", ("enc_pos_alpha",))
    lay.ln(f"{wenc}.layer_norm", ("enc_ln",), D)
    for i in range(cfg.encoder_layers):
        p, q = f"{wenc}.layers.{i}", ("enc_layers",)
        lay.attn(f"{p}.attention", q + ("attn",), D, i)
        lay.ln(f"{p}.layer_norm", q + ("ln1",), D, i)
        lay.lin(f"{p}.feed_forward.intermediate_dense", q + ("ffn", "in"), D, cfg.encoder_ffn_dim, i)
        lay.lin(f"{p}.feed_forward.output_dense", q + ("ffn", "out"), cfg.encoder_ffn_dim, D, i)
        lay.ln(f"{p}.final_layer_norm", q + ("ln2",), D, i)
    lay.add(f"{wenc}.embed_positions.pe_k.weight",
            (2 * cfg.encoder_max_relative_position, cfg.head_dim), "normal", ("enc_rel_pos", "w"))
    units = cfg.speech_decoder_prenet_units
    for j in range(cfg.speech_decoder_prenet_layers):
        lay.lin(f"{dec}.prenet.layers.{j}", ("dec_prenet", "layers", j), M if j == 0 else units,
                units)
    lay.lin(f"{dec}.prenet.final_layer", ("dec_prenet", "final"), units, D)
    lay.add(f"{dec}.prenet.encode_positions.alpha", (), "ones", ("dec_prenet", "pos_alpha"))
    lay.lin(f"{dec}.prenet.speaker_embeds_layer", ("dec_prenet", "speaker"),
            cfg.speaker_embedding_dim + D, D)
    for i in range(cfg.decoder_layers):
        p, q = f"{wdec}.layers.{i}", ("dec_layers",)
        lay.attn(f"{p}.self_attn", q + ("self_attn",), D, i)
        lay.ln(f"{p}.self_attn_layer_norm", q + ("ln1",), D, i)
        lay.attn(f"{p}.encoder_attn", q + ("cross_attn",), D, i)
        lay.ln(f"{p}.encoder_attn_layer_norm", q + ("ln2",), D, i)
        lay.lin(f"{p}.feed_forward.intermediate_dense", q + ("ffn", "in"), D, cfg.decoder_ffn_dim, i)
        lay.lin(f"{p}.feed_forward.output_dense", q + ("ffn", "out"), cfg.decoder_ffn_dim, D, i)
        lay.ln(f"{p}.final_layer_norm", q + ("ln3",), D, i)
    lay.lin(f"{post}.feat_out", ("feat_out",), D, M * cfg.reduction_factor)
    lay.lin(f"{post}.prob_out", ("prob_out",), D, cfg.reduction_factor)
    n = cfg.speech_decoder_postnet_layers
    chans = [M] + [cfg.speech_decoder_postnet_units] * (n - 1) + [M]
    for i in range(n):
        p, q, c = f"{post}.layers.{i}", ("postnet", i), chans[i + 1]
        lay.conv(f"{p}.conv", q + ("conv",), (c, chans[i], cfg.speech_decoder_postnet_kernel),
                 bias=False)
        lay.add(f"{p}.batch_norm.weight", (c,), "ones", q + ("bn", "g"))
        lay.add(f"{p}.batch_norm.bias", (c,), "zeros", q + ("bn", "b"))
        lay.add(f"{p}.batch_norm.running_mean", (c,), "zeros", q + ("bn", "running_mean"))
        lay.add(f"{p}.batch_norm.running_var", (c,), "ones", q + ("bn", "running_var"))
        lay.add(f"{p}.batch_norm.num_batches_tracked", (), "count", None)
    return lay


def hf_hifigan_layout(cfg) -> HFLayout:
    """HF ``SpeechT5HifiGan``'s state dict at ``cfg``'s dims (``scale`` ones:
    a zero scale divides the input by zero)."""
    lay, M, ch = HFLayout(), cfg.model_in_dim, cfg.upsample_initial_channel
    lay.add("mean", (M,), "zeros", ("mean",))
    lay.add("scale", (M,), "ones", ("scale",))
    lay.conv("conv_pre", ("conv_pre",), (ch, M, 7))
    nk = len(cfg.resblock_kernel_sizes)
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        lay.conv(f"upsampler.{i}", ("ups", i), (c_in, c_out, k), transposed=True)
        for j, (ksz, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                            cfg.resblock_dilation_sizes)):
            for conv in ("convs1", "convs2"):
                for d in range(len(dils)):
                    lay.conv(f"resblocks.{i * nk + j}.{conv}.{d}",
                             ("resblocks", i * nk + j, conv, d), (c_out, c_out, ksz))
    lay.conv("conv_post", ("conv_post",), (1, ch // 2 ** len(cfg.upsample_rates), 7))
    return lay


def hf_state_dict(torch, lay: HFLayout, generator, sin_table=None) -> dict:
    """Tensors for ``lay``'s rows on the generator's device, at HF's init."""
    dev = generator.device
    sd = {}
    for key, shape, init, _, _ in lay.rows:
        if init == "normal":
            t = torch.empty(shape, device=dev).normal_(0.0, HF_INIT_STD, generator=generator)
        elif init in ("zeros", "ones"):
            t = (torch.zeros if init == "zeros" else torch.ones)(shape, device=dev)
        elif init == "sin":
            t = torch.from_numpy(sin_table).to(dev)
        elif init == "count":
            t = torch.zeros(shape, dtype=torch.long, device=dev)
        else:  # tied: the same tensor, as HF's state_dict() gives it
            t = sd[init.split(":", 1)[1]]
        sd[key] = t
    return sd


def leaf_at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def check_ported(torch, name, lay: HFLayout, sd: dict, params, stored=None) -> int:
    """Every row's tensor, as the HF file stores it (``stored``: a floating
    tensor rounded to that dtype and widened back), is bit for bit its leaf
    of ``params`` under the row's layout, the rows are the state dict's
    keys, and they cover every element of ``params``.  Returns the elements
    checked."""
    check(set(sd) == {r[0] for r in lay.rows},
          f"ckpt_port {name}: the layout and the state dict differ")
    covered = 0
    for key, _, init, path, layout in lay.rows:
        if path is None:
            continue
        t = sd[key]
        if stored is not None and t.is_floating_point():
            t = t.to(stored).float()
        want = t.T if layout == "T" else t.permute(2, 1, 0) if layout == "K" else t
        got = leaf_at(params, path)
        check(got.dtype == torch.float32 and got.device == t.device and torch.equal(got, want),
              f"ckpt_port {name}: leaf {path} differs from {key} ({layout or 'as is'})")
        covered += got.numel()
    total = sum(t.numel() for _, t in ckpt_flatten(params))
    check(covered == total, f"ckpt_port {name}: the state dict covers {covered} of "
                            f"{total} elements of the tree")
    return total


def ckpt_flatten(tree):
    from infernos_tpu_torch.models.checkpoint import flatten

    return flatten(tree)


def drop_cached(path) -> None:
    """Write ``path`` out and advise the kernel to drop its cached pages, so
    that the next read comes from the disk where the file system honours
    the advice."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def fault_at(tree, path, fault, n_heads):
    """``tree`` with ``fault`` in the first layer of the stacked linear
    weight at ``path`` (``[L, in, out]``): its first head's input rows
    zeroed (``head``), or all of them (``layer``).  A copy of the dicts
    along ``path`` and of that leaf, the other leaves shared."""
    if not path:
        w = tree.clone()
        w[0, :w.shape[1] // n_heads if fault == "head" else None] = 0
        return w
    return {**tree, path[0]: fault_at(tree[path[0]], path[1:], fault, n_heads)}


def dequantized(torch, tree):
    """A tree with each int8 node (``{"w_q", "scale"[, "b"]}``) made dense
    in fp32 (codes times scales) and every other floating leaf widened to
    fp32."""
    if isinstance(tree, dict):
        if "w_q" in tree:
            out = {"w": tree["w_q"].float() * tree["scale"].float()[..., None, :]}
            if "b" in tree:
                out["b"] = tree["b"].float()
            return out
        return {k: dequantized(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequantized(torch, v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


# -- the HF hub cache the phase ports from ------------------------------------

HF_COMMIT = "0" * 40  # the snapshot every repo's refs/main names
CKPT_REPOS = {"whisper": "openai/whisper-large-v3", "speecht5": "microsoft/speecht5_tts",
              "hifigan": "microsoft/speecht5_hifigan"}
CKPT_WHISPER_SHARDS = 2  # large-v3 as fp16 safetensors shards with their index
CKPT_CLI_TIMEOUT_S = 600.0  # one run of the porter's CLI
TOKENIZER_CORPUS = ["the line is open, please go ahead", "good morning how can i help you"] * 4


def hf_snapshot_dir(root: str, name: str) -> str:
    """The snapshot directory of repo ``name`` in a hub cache at ``root``
    (``models--org--repo/refs/main`` naming ``snapshots/<commit>``)."""
    repo = os.path.join(root, "models--" + name.replace("/", "--"))
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(HF_COMMIT)
    snap = os.path.join(repo, "snapshots", HF_COMMIT)
    os.makedirs(snap, exist_ok=True)
    return snap


def write_safetensors(torch, path: str, tensors: dict) -> int:
    """``tensors`` (name -> tensor, on any device) as one safetensors file:
    an 8-byte little-endian header length, the JSON header padded to 8
    bytes, then each tensor's little-endian bytes.  Returns the file's size."""
    from infernos_tpu_torch.models.hf_snapshot import SAFETENSORS_DTYPES

    names = {dtype: name for name, dtype in SAFETENSORS_DTYPES.items()}
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype],
                     "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().data)
    return 8 + len(head) + off


def write_hf_snapshot(torch, root: str, name: str, sd: dict, hc, gen=None) -> int:
    """Model ``name``'s HF state dict ``sd`` and config stand-ins in the hub
    cache at ``root``, laid out as the published repos store them: Whisper
    large-v3 as ``CKPT_WHISPER_SHARDS`` fp16 safetensors shards with an
    index (``proj_out.weight`` left out, as ``save_pretrained`` keeps one of
    a tied pair), ``generation_config.json`` and tokenizer files from
    ``train_bpe``; SpeechT5 as one fp32 ``model.safetensors``; HiFi-GAN as
    ``pytorch_model.bin``.  Returns the weight files' bytes."""
    snap = hf_snapshot_dir(root, CKPT_REPOS[name])
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(vars(hc), f)
    if name == "whisper":
        from infernos_tpu_torch.models.bpe import train_bpe

        with open(os.path.join(snap, "generation_config.json"), "w") as f:
            json.dump(vars(gen), f)
        train_bpe(TOKENIZER_CORPUS, vocab_size=300).save(
            os.path.join(snap, "vocab.json"), os.path.join(snap, "merges.txt"))
        stored = {k: t.half() for k, t in sd.items() if k != "proj_out.weight"}
        per = sum(t.numel() * 2 for t in stored.values()) / CKPT_WHISPER_SHARDS
        shards, size = [[]], 0
        for k, t in stored.items():
            if size >= per * len(shards):
                shards.append([])
            shards[-1].append(k)
            size += t.numel() * 2
        weight_map, n = {}, 0
        for i, keys in enumerate(shards):
            fn = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            n += write_safetensors(torch, os.path.join(snap, fn), {k: stored[k] for k in keys})
            weight_map.update({k: fn for k in keys})
        with open(os.path.join(snap, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": size}, "weight_map": weight_map}, f)
        return n
    if name == "speecht5":
        return write_safetensors(torch, os.path.join(snap, "model.safetensors"), sd)
    path = os.path.join(snap, "pytorch_model.bin")
    torch.save({k: t.cpu() for k, t in sd.items()}, path)
    return os.path.getsize(path)


def run_porter(device: str, hub: str, out: str, *flags) -> float:
    """``python -m infernos_tpu_torch.tools.port_checkpoints FLAGS --out OUT``
    in a subprocess reading the hub cache ``hub`` (on the card, or on the
    CPU with ``device`` "cpu"); its wall seconds."""
    import subprocess

    env = {**os.environ, "HF_HUB_CACHE": hub}
    env.pop("INFERNOS_DEVICE", None)
    if device == "cpu":
        env["INFERNOS_DEVICE"] = "cpu"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "infernos_tpu_torch.tools.port_checkpoints",
                        *flags, "--out", out], cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=env, capture_output=True, text=True, timeout=CKPT_CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"ckpt_port: port_checkpoints {' '.join(flags)} exited "
                             f"{r.returncode}: {r.stderr[-3000:]}")
    return seconds


def ckpt_setup(torch):
    """The ``ckpt_port`` phase's models and engines: the card, full width and
    depth, bf16 engines, the STT decode capped as the ramp caps it."""
    from infernos_tpu_torch.models import presets
    from infernos_tpu_torch.serving import stt_engine as stt
    from infernos_tpu_torch.serving.tts_engine import TTSEngineConfig

    return types.SimpleNamespace(
        device="cuda", tiny=False,
        whisper=presets.WHISPER_LARGE_V3, speecht5=presets.SPEECHT5_FULL,
        hifigan=presets.HIFIGAN_FULL,
        stt=stt.STTEngineConfig(dtype=torch.bfloat16, batch_slots=4,
                                max_new_tokens=int(LT_RAMP_ENV["INFERNOS_STT_MAX_NEW"])),
        tts=TTSEngineConfig(batch_slots=8, max_text_tokens=96, max_steps=CKPT_TTS_STEPS,
                            stop_threshold=2.0, dtype=torch.bfloat16))


def ckpt_import(torch, s, tmp: str, out: dict) -> dict:
    """The import half of ``ckpt_port``: HF-layout state dicts (HF's init
    from the seeded generator) written into a hub cache under ``tmp``, the
    porter's CLI run on it twice (``--stt --tts``, then ``--tts --int8``),
    and its checkpoints loaded and held to the state dicts as stored.
    Returns the loaded trees: ``whisper``, ``speecht5``, ``hifigan`` (fp32)
    and ``speecht5_int8``."""
    from infernos_tpu_torch.models import checkpoint as ckpt
    from infernos_tpu_torch.models import hifigan as hfg
    from infernos_tpu_torch.models import quant
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.models.tokenizers import load_tokenizer

    device, g = s.device, torch.Generator(device=s.device).manual_seed(CKPT_SEED)
    hub = os.path.join(tmp, "hub")
    models = {"whisper": (s.whisper, wsp, hf_whisper_layout, hf_whisper_config, torch.float16),
              "speecht5": (s.speecht5, st5, hf_speecht5_layout, hf_speecht5_config, None),
              "hifigan": (s.hifigan, hfg, hf_hifigan_layout, hf_hifigan_config, None)}
    sds, lays, likes, hf_bytes = {}, {}, {}, {}
    t0 = time.perf_counter()
    for name, (cfg, mod, layout, standin, _) in models.items():
        lay = layout(cfg)
        sd = hf_state_dict(torch, lay, g, wsp._sinusoids(cfg.max_source_positions, cfg.d_model)
                           if name == "whisper" else None)
        hc = standin(cfg)
        hc, gen = hc if name == "whisper" else (hc, None)
        hf_bytes[name] = write_hf_snapshot(torch, hub, name, sd, hc, gen)
        # the tree's structure and shapes (``checkpoint.load``'s ``like``):
        # port_from_hf of the same keys on the meta device
        meta = {k: torch.empty_like(t, device="meta") for k, t in sd.items()}
        like, pcfg = mod.port_from_hf(types.SimpleNamespace(
            config=hc, generation_config=gen, state_dict=lambda meta=meta: meta))
        check(pcfg == cfg, f"ckpt_port {name}: ported config {pcfg} != preset")
        sds[name], lays[name], likes[name] = sd, lay, like
    torch.cuda.synchronize()
    out["hf_cache"] = {"bytes": hf_bytes, "write_s": time.perf_counter() - t0,
                       "whisper_shards": CKPT_WHISPER_SHARDS}
    dense, int8 = os.path.join(tmp, "fp32"), os.path.join(tmp, "int8")
    out["cli_s"] = {"stt_tts": run_porter(device, hub, dense, "--stt", "--tts"),
                    "tts_int8": run_porter(device, hub, int8, "--tts", "--int8")}

    loaded = {}
    for name, sub in (("whisper", "whisper"), ("speecht5", "tts_en"), ("hifigan", "hifigan")):
        cfg, stored = models[name][0], models[name][4]
        path = os.path.join(dense, sub)
        file = os.path.join(path, ckpt.PARAMS_PT)
        t0 = time.perf_counter()
        drop_cached(file)
        t1 = time.perf_counter()
        back = ckpt.load(path, likes[name], device=device)
        lcfg = ckpt.load_config(path, type(cfg))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        again = ckpt.load(path, likes[name], device=device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del again
        check(lcfg == cfg, f"ckpt_port {name}: load_config gave {lcfg}")
        n = check_ported(torch, name, lays[name], sds[name], back, stored)
        out[name] = {"hf_keys": len(lays[name].rows), "elements": n,
                     "bytes_on_disk": os.path.getsize(file), "drop_s": t1 - t0,
                     "load_after_drop_s": t2 - t1, "load_cached_s": t3 - t2}
        loaded[name] = back
        del sds[name]
        torch.cuda.empty_cache()

    # --int8: the same SpeechT5 tree through quantize_params, HiFi-GAN dense
    q = ckpt.load(os.path.join(int8, "tts_en"), quant.quantize_params(likes["speecht5"]),
                  device=device)
    want = quant.quantize_params(loaded["speecht5"])
    codes = 0
    for (k, a), (k2, b) in zip(ckpt_flatten(q), ckpt_flatten(want)):
        check(k == k2 and a.dtype == b.dtype and torch.equal(a, b),
              f"ckpt_port: int8 leaf {k} ({a.dtype}) != quantize_params' {k2} ({b.dtype})")
        codes += a.numel() if a.dtype == torch.int8 else 0
    check(codes > 0, "ckpt_port: the --int8 TTS checkpoint holds no int8 code")
    voc = ckpt.load(os.path.join(int8, "hifigan"), likes["hifigan"], device=device)
    check(all(torch.equal(a, b) for (_, a), (_, b) in
              zip(ckpt_flatten(voc), ckpt_flatten(loaded["hifigan"]))),
          "ckpt_port: --int8 changed HiFi-GAN")
    loaded["speecht5_int8"] = q
    out["speecht5_int8"] = {"codes": codes, "bytes_on_disk": os.path.getsize(
        os.path.join(int8, "tts_en", ckpt.PARAMS_PT))}

    # the tokenizer files, copied as the snapshot holds them
    tokdir, snap = os.path.join(dense, "whisper", "tokenizer"), hf_snapshot_dir(
        hub, CKPT_REPOS["whisper"])
    for f in ("vocab.json", "merges.txt"):
        with open(os.path.join(tokdir, f), "rb") as a, open(os.path.join(snap, f), "rb") as b:
            check(a.read() == b.read(), f"ckpt_port: whisper/tokenizer/{f} differs")
    text = TOKENIZER_CORPUS[0]
    check(load_tokenizer(tokdir).detokenize(load_tokenizer(tokdir)(text)) == text,
          "ckpt_port: the copied tokenizer does not round-trip")
    check(not os.path.exists(os.path.join(dense, "tts_en", "tokenizer")),
          "ckpt_port: a SpeechT5 tokenizer was written (the reference saves none)")
    return loaded


def say_recorded(torch, actor, text: str, st5, tts_engine):
    """``actor`` says ``text``; returns what each step of its slot took and
    gave (``x``, ``h``), its encoder output and mask (``enc``, ``mask``),
    the audio chunks, the seconds and the decoder steps."""
    from infernos_tpu_torch.serving import sessions as ses

    teng = actor.engine
    rec = {"tts": None, "x": [], "h": [], "enc": None, "mask": None, "chunks": []}
    join_many, encode_text, step = teng._join_many, st5.encode_text, tts_engine.fused_decode_step
    frames0 = sum(teng.tick_frames)

    def rec_join_many(slots, input_ids, attn_mask, spk):
        rec["tts"], rec["mask"] = slots[0], attn_mask[:1].clone()
        return join_many(slots, input_ids, attn_mask, spk)

    def rec_encode_text(*a, **kw):
        enc = encode_text(*a, **kw)
        rec["enc"] = enc[:1].clone()
        return enc

    def rec_step(params, cfg, x, *a, **kw):
        h = step(params, cfg, x, *a, **kw)
        rec["x"].append(x[rec["tts"], 0].clone())
        rec["h"].append(h[rec["tts"], 0].float().clone())
        return h

    def soundout(item):
        if hasattr(item, "on_proc"):  # the say's end marker
            item.on_proc()
        else:
            rec["chunks"].append(item.audio)

    said = threading.Event()
    with mock.patch.object(teng, "_join_many", rec_join_many), \
            mock.patch.object(st5, "encode_text", rec_encode_text), \
            mock.patch.object(tts_engine, "fused_decode_step", rec_step):
        sid = actor.new_tts_session()
        actor.tts_session_start(sid, soundout)
        t0 = time.perf_counter()
        actor.tts_session_say(sid, ses.TTSRequest(text, speaker_id=0, done_cb=said.set))
        check(said.wait(120.0), "ckpt_port: the TTS say did not end")
        rec["seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    rec["steps"] = (sum(teng.tick_frames) - frames0) // teng.cfg.reduction_factor
    actor.tts_session_end(sid)
    return rec


def phase_ckpt_port(torch, attn, setup=None):
    """Phase ``ckpt_port``: weight import and checkpoints at full width,
    through the porter's command line.

    Builds HF-layout state dicts on the card (Whisper large-v3, SpeechT5,
    HiFi-GAN; HF's init from a seeded generator) and writes them, with
    config stand-ins carrying HF's field names, into a hub cache laid out as
    the published repos are (``write_hf_snapshot``); runs ``python -m
    infernos_tpu_torch.tools.port_checkpoints --stt --tts`` and ``--tts
    --int8`` on it in subprocesses (``HF_HUB_CACHE``); loads their
    checkpoints after dropping each file's cached pages, and again from the
    page cache, and holds every leaf bit for bit to its HF tensor as stored
    (Whisper's fp16 widened), the configs to the presets and the int8 tree
    to ``quantize_params`` of the fp32 one (``ckpt_import``).  Then serves
    them: ``STTActor(params=...)`` transcribes one 5 s utterance (kernel 1
    in its encode, held against the plain encode in fp32) with tokens
    capped as the ramp caps them, held against ``whisper.decode_full`` in
    fp32 teacher-forced over its prompt and tokens; ``TTSActor(params=...,
    voc_params=...)`` says one sentence for ``CKPT_TTS_STEPS`` steps
    (kernel 2), each step's hidden state held against
    ``speecht5.decode_full`` over the same prenet inputs, and every audio
    sample finite; a second ``TTSActor`` on the int8 checkpoint says it
    again (kernel 2's int8 mode), held against ``decode_full`` of that
    tree dequantized.  Each agreement is also read against references with
    a fault (``fault_at``): one head zeroed, which must fail the encoder and
    TTS checks, and one layer's attention dropped, which must fail every
    check; the fp32 free-running greedy decode's distinct tokens are
    reported beside the engine's.
    Returns the launches of kernel 1, kernel 2 and kernel 2's int8 mode
    after the actors' warm-ups.  ``setup`` (default ``ckpt_setup``) names
    the device, models and engine configs: the tests pass the tiny ones on
    the CPU, where no kernel launches."""
    import shutil
    import tempfile

    from infernos_tpu_torch.cluster.model_actors import STTActor, TTSActor
    from infernos_tpu_torch.models import layers as L
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.models.convert import cast_floating
    from infernos_tpu_torch.models.tiny_real import serving_dtype
    from infernos_tpu_torch.ops import tts_step as ts
    from infernos_tpu_torch.serving import stt_engine as stt
    from infernos_tpu_torch.serving import tts_engine
    from infernos_tpu_torch.utils.platform import card_info

    s = setup or ckpt_setup(torch)
    device, wcfg, scfg, vcfg = s.device, s.whisper, s.speecht5, s.hifigan
    out = {"card": card_info(), "seed": CKPT_SEED}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        loaded = ckpt_import(torch, s, tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), "ckpt_port: the checkpoint directory was left")

    sttact = STTActor(tiny=s.tiny, params=loaded["whisper"], device=device, ecfg=s.stt)
    ttsact = TTSActor(tiny=s.tiny, params=loaded["speecht5"], voc_params=loaded["hifigan"],
                      device=device, ecfg=s.tts)
    ttsq = TTSActor(tiny=s.tiny, params=loaded["speecht5_int8"], voc_params=loaded["hifigan"],
                    device=device, ecfg=s.tts)
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ):
        os.environ.pop("INFERNOS_MODEL_MODE", None)  # these weights, not tiny-real's
        sttact.start()
        ttsact.start()
        ttsq.start()
    out["actors_start_s"] = time.perf_counter() - t0
    seng = sttact.engine
    max_new = seng.ecfg.max_new_tokens
    enc0 = len(seng.encode_ms)
    rec = {"slot": None, "logits": []}
    join, encode, decode_step = seng._join, wsp.encode, wsp.decode_step

    def rec_encode(params, cfg, mel):
        rec["mel"] = mel.clone()
        return encode(params, cfg, mel)

    def rec_join(slot, enc_out, *a, **kw):
        rec["slot"], rec["stt_enc"] = slot, enc_out.clone()
        return join(slot, enc_out, *a, **kw)

    def rec_decode_step(*a, **kw):
        logits = decode_step(*a, **kw)
        rec["logits"].append(logits[rec["slot"]].float().clone())
        return logits

    results, done = [], threading.Event()
    reset_launch_counts()  # the bf16 main path starts here
    with mock.patch.object(seng, "_join", rec_join), \
            mock.patch.object(wsp, "encode", rec_encode), \
            mock.patch.object(wsp, "decode_step", rec_decode_step):
        audio = synth_audio(np.random.default_rng(13), CKPT_UTTER_S)
        req = stt.STTRequest(audio=audio, text_cb=lambda r: (results.append(r), done.set()))
        t0 = time.perf_counter()
        seng.submit(req)
        sttact.driver.kick()
        check(done.wait(120.0), "ckpt_port: the STT actor did not call back")
        stt_s = time.perf_counter() - t0
    said = say_recorded(torch, ttsact, FIXED_SENTENCE, st5, tts_engine)
    c = launch_counts()  # read right after the main path: full width, the bf16 modes
    attn_launches, step_launches = path_launches(c, "ckpt_port", fp32=False)
    int8_launches = c["int8_step"]
    reset_launch_counts()  # the int8 path
    said8 = say_recorded(torch, ttsq, FIXED_SENTENCE, st5, tts_engine)
    c = launch_counts()  # read right after the int8 path
    q_launches = path_launches(c, "ckpt_port int8", fp32=False, int8=True)[1]
    q_bf16_launches = c["bf16_step"]
    encodes = len(seng.encode_ms) - enc0
    sttact.on_stop()
    for a in (ttsact, ttsq):
        a.on_stop()
        a.engine.close()

    # the weights as the engines serve them (bf16 on the card), widened to fp32
    def served(tree):
        return cast_floating(cast_floating(tree, serving_dtype(device, tiny=False)),
                             torch.float32)

    # the engine's encoder output against the plain encode in fp32
    w32 = served(loaded["whisper"])
    plain = lambda q, k, v, *, n_heads, mask=None: attn.by_heads(
        attn._plain_attention, q, k, v, n_heads=n_heads, mask=mask)
    S = rec["stt_enc"].shape[1]
    got_enc = rec["stt_enc"].float()

    def enc_error(params):
        with torch.no_grad(), mock.patch.object(wsp, "fused_attention", plain):
            want = wsp.encode(params, wcfg, rec["mel"].float())[:, :S]
        return float((got_enc - want).norm() / want.norm()), want

    enc_rel, enc32 = enc_error(w32)
    faults = {f: {"encoder_rel_err": enc_error(fault_at(
        w32, ("enc_layers", "attn", "o", "w"), f, wcfg.encoder_attention_heads))[0]}
        for f in CKPT_FAULTS}

    # STT: the engine's greedy tokens against decode_full in fp32
    res = results[0]
    toks = list(res.tokens)
    prompt, _ = seng._build_prompt(req)
    P = len(prompt)
    check(toks, "ckpt_port: the STT decode gave no token")
    targets = toks + ([wcfg.eos_token_id] if len(toks) < max_new else [])
    dec32 = {k: w32[k] for k in DECODER_KEYS}
    del w32

    def suppress(logits, first_row=True):
        """The engine's masks: ``_sup`` on every row, ``_first_sup`` on the first."""
        if seng._sup is not None:
            logits[:, seng._sup] = L.NEG_INF
        if first_row and seng._first_sup is not None:
            logits[0, seng._first_sup] = L.NEG_INF
        return logits

    # the first token is the prefill's argmax
    eng_lp = [float(torch.log_softmax(suppress(rec["logits"][j - 1][None].clone(), False)[0],
                                      -1)[targets[j]]) for j in range(1, len(targets))]

    def agreement(dec):
        """(argmaxes, margins, rows decided, rows whose token is not the
        argmax, logprob errors) of the engine's tokens against ``dec``."""
        with torch.no_grad():
            seq = torch.tensor([prompt + targets[:-1]], device=device)
            ref = suppress(wsp.decode_full(dec, wcfg, seq, rec["stt_enc"].float())[0, P - 1:])
        lp = torch.log_softmax(ref, dim=-1)
        top2 = torch.topk(ref, 2, dim=-1)
        margins = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        argmax = top2.indices[:, 0].tolist()
        decided = [j for j, m in enumerate(margins) if m > CKPT_MARGIN]
        wrong = [j for j in decided if argmax[j] != targets[j]]
        err = [abs(e - float(lp[j, targets[j]])) for j, e in enumerate(eng_lp, 1)]
        return argmax, margins, decided, wrong, err

    argmax, margins, decided, wrong, lp_err = agreement(dec32)
    cross_o = ("dec_layers", "cross_attn", "o", "w")
    for f in CKPT_FAULTS:
        _, _, f_decided, f_wrong, f_lp_err = agreement(
            fault_at(dec32, cross_o, f, wcfg.decoder_attention_heads))
        faults[f].update(stt_logprob_max_err=max(f_lp_err), stt_argmax_checked=len(f_decided),
                         stt_argmax_wrong=len(f_wrong))
    greedy = []  # fp32 free-running greedy decode from the plain encode
    with torch.no_grad():
        while len(greedy) < max_new:
            seq = torch.tensor([prompt + greedy], device=device)
            logits = wsp.decode_full(dec32, wcfg, seq, enc32)[0, -1:]
            tok = int(suppress(logits, first_row=not greedy)[0].argmax())
            if tok == wcfg.eos_token_id:
                break
            greedy.append(tok)
    del dec32, enc32

    # TTS: the step kernel's hidden states against decode_full in fp32, the
    # bf16 checkpoint on its weights as served and the int8 one dequantized
    T = CKPT_TTS_STEPS
    hop = vcfg.total_upsample

    def tts_check(r, ref_tree, what):
        check(len(r["h"]) >= T, f"ckpt_port {what}: {len(r['h'])} decoder steps recorded, "
                                f"want {T}")
        x = torch.stack(r["x"][:T])[None].float()
        got = torch.stack(r["h"][:T])

        def step_errors(params):
            with torch.no_grad():
                want = st5.decode_full(params, scfg, x, r["enc"].float(), enc_mask=r["mask"])[0]
            return ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist(), float(
                (got - want).abs().max())

        step_rel, dec_max_abs = step_errors(ref_tree)
        fault_rel = {f: max(step_errors(fault_at(ref_tree, cross_o, f,
                                                 scfg.decoder_attention_heads))[0])
                     for f in CKPT_FAULTS}
        wav = np.concatenate(r["chunks"]) if r["chunks"] else np.zeros(0, np.float32)
        rep = {"steps": r["steps"], "seconds": r["seconds"], "step_rel_err_max": max(step_rel),
               "hidden_max_abs_err": dec_max_abs, "samples": int(wav.size),
               "finite": bool(np.isfinite(wav).all()),
               "peak": float(np.abs(wav).max()) if wav.size else 0.0,
               "rms": float(np.sqrt(np.mean(np.square(wav, dtype=np.float64))))
               if wav.size else 0.0}
        return rep, fault_rel

    tts, tts_faults = tts_check(said, served(loaded["speecht5"]), "tts")
    for f in CKPT_FAULTS:
        faults[f]["tts_step_rel_err_max"] = tts_faults[f]
    tts8, tts8_faults = tts_check(
        said8, dequantized(torch, cast_floating(loaded["speecht5_int8"],
                                                serving_dtype(device, tiny=False))),
        "tts_int8")
    for f in CKPT_FAULTS:
        faults[f]["tts_int8_step_rel_err_max"] = tts8_faults[f]
    out.update(
        stt={"tokens": toks, "distinct": len(set(toks)), "prompt_len": P, "seconds": stt_s,
             "argmax_checked": len(decided), "margins_min_max": [min(margins), max(margins)],
             "logprob_max_err": max(lp_err), "avg_logprob": res.avg_logprob,
             "encoder_rel_err": enc_rel, "encodes": encodes,
             "fp32_greedy_tokens": greedy, "fp32_greedy_distinct": len(set(greedy))},
        tts=tts, tts_int8=tts8, faults=faults,
        launches={"attention": attn_launches, "bf16_step": step_launches,
                  "int8_step": int8_launches, "int8_path_bf16_step": q_bf16_launches,
                  "int8_path_int8_step": q_launches},
        tolerances={"margin": CKPT_MARGIN, "logprob": CKPT_LOGPROB_TOL,
                    "dec_rel": CKPT_DEC_REL_TOL, "int8_dec_rel": CKPT_INT8_DEC_REL_TOL,
                    "enc_rel": CKPT_ENC_REL_TOL})
    emit("ckpt_port", **out)
    check(enc_rel <= CKPT_ENC_REL_TOL,
          f"ckpt_port: the engine's encoder output differs from the plain encode's by "
          f"{enc_rel} relative")
    check(not wrong, f"ckpt_port: tokens {[(j, targets[j], argmax[j]) for j in wrong]} are not "
                     f"decode_full's argmax despite a margin over {CKPT_MARGIN}")
    check(max(lp_err) <= CKPT_LOGPROB_TOL,
          f"ckpt_port: token logprobs differ from decode_full's by up to {max(lp_err)}")
    check(tts["step_rel_err_max"] <= CKPT_DEC_REL_TOL,
          f"ckpt_port: step hidden states differ from decode_full's by "
          f"{tts['step_rel_err_max']} relative")
    check(tts8["step_rel_err_max"] <= CKPT_INT8_DEC_REL_TOL,
          f"ckpt_port: int8 step hidden states differ from decode_full's of the dequantized "
          f"tree by {tts8['step_rel_err_max']} relative")
    for f in faults.values():
        check(f["encoder_rel_err"] > CKPT_ENC_REL_TOL
              and f["tts_step_rel_err_max"] > CKPT_DEC_REL_TOL
              and f["tts_int8_step_rel_err_max"] > CKPT_INT8_DEC_REL_TOL,
              f"ckpt_port: the encoder or a TTS check passes with a fault: {faults}")
    f = faults["layer"]
    check(f["stt_argmax_wrong"] or f["stt_logprob_max_err"] > CKPT_LOGPROB_TOL,
          f"ckpt_port: the STT check passes with the first layer's attention dropped: {f}")
    for rep in (tts, tts8):
        check(rep["samples"] >= T * scfg.reduction_factor * hop and rep["finite"],
              f"ckpt_port: {rep['samples']} samples, finite {rep['finite']}")
    check(encodes == 1 and tts["steps"] >= T and tts8["steps"] >= T,
          f"ckpt_port: {encodes} encodes, {tts['steps']} and {tts8['steps']} steps")
    kernels = device == "cuda"  # the plain versions run on the CPU, where nothing launches
    check(attn_launches == kernels * wcfg.encoder_layers * encodes,
          f"ckpt_port: attention kernel launched {attn_launches} times for {encodes} encodes")
    check(step_launches == kernels * tts["steps"] and int8_launches == 0,
          f"ckpt_port: step kernel launched {step_launches} (int8 {int8_launches}) times "
          f"for {tts['steps']} steps")
    check(q_launches == kernels * tts8["steps"] and q_bf16_launches == 0,
          f"ckpt_port: int8 step kernel launched {q_launches} (bf16 {q_bf16_launches}) times "
          f"for {tts8['steps']} steps")
    check(len(toks) <= max_new and len(set(toks)) > 1,
          f"ckpt_port: the STT decode is degenerate: {toks}")
    del loaded
    torch.cuda.empty_cache()
    return attn_launches, step_launches, q_launches


# -- phase examples: the two runnable examples ---------------------------------

EXAMPLE_TEXTS = ("Hello from the port's streaming demo.", "Twenty milliseconds per packet.")
EXAMPLE_FRAMES = 96  # tts_stream's max_frames per session
EXAMPLE_LLM = (4, 2)  # llm_test's sessions and rounds, tiny width


def phase_examples(torch, tiny: bool = False):
    """Phase ``examples``: ``infernos_tpu_torch.examples.tts_stream --full``
    says two texts (every decoder step through kernel 2) and must write a
    WAV of ``EXAMPLE_FRAMES`` mel frames per text; ``llm_test`` at tiny
    width runs ``EXAMPLE_LLM`` sessions and rounds, each of which must
    record a latency.  Returns kernel 2's launches over both (``tiny``, on
    the CPU in the tests: the tiny TTS, no launch)."""
    import shutil
    import tempfile
    import wave

    from infernos_tpu_torch.examples import llm_test, tts_stream
    from infernos_tpu_torch.models import presets
    from infernos_tpu_torch.ops import tts_step as ts

    voc = presets.HIFIGAN_TINY if tiny else presets.HIFIGAN_FULL
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        reset_launch_counts()  # the path starts here
        t0 = time.perf_counter()
        written = tts_stream.main([*EXAMPLE_TEXTS, "--out", tmp] + ([] if tiny else ["--full"]))
        tts_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lat = llm_test.main(*EXAMPLE_LLM)
        llm_s = time.perf_counter() - t0
        c = launch_counts()  # read right after the path
        launches = path_launches(c, "examples", fp32=tiny)[1]
        int8_launches = c["int8_step"]
        wavs = []
        for path in sorted(written):
            with wave.open(path) as w:
                wavs.append((w.getframerate(), w.getnframes()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("examples", tts_stream={"wavs": wavs, "seconds": tts_s},
         llm_test={"requests": len(lat), "seconds": llm_s,
                   "latency_p50_s": float(np.median(lat)) if lat else None,
                   "latency_max_s": max(lat) if lat else None},
         launches={"bf16_step": launches, "int8_step": int8_launches})
    check(len(wavs) == len(EXAMPLE_TEXTS)
          and all(n == EXAMPLE_FRAMES * voc.total_upsample for _, n in wavs),
          f"examples: tts_stream wrote {wavs}, want {len(EXAMPLE_TEXTS)} of "
          f"{EXAMPLE_FRAMES * voc.total_upsample} samples")
    check(len(lat) == EXAMPLE_LLM[0] * EXAMPLE_LLM[1],
          f"examples: llm_test recorded {len(lat)} latencies")
    # one launch a step of the two sessions (max_frames / reduction 2), and
    # the warm-up's
    want = 0 if tiny else EXAMPLE_FRAMES // 2
    check(launches >= want and int8_launches == 0 and (launches > 0) == (not tiny),
          f"examples: step kernel launched {launches} (int8 {int8_launches}) times")
    return launches


# -- phase train: the trainers on the card, through a differentiable kernel 1 ---

# dq/dk/dv of KernelAttention against fp32 autograd of the plain attention on
# the same inputs: its backward recomputes that same fp32 attention.  bf16
# inputs: the two differ by the rounding of each gradient to bf16 (2^-9
# relative) and the bf16 output's own rounding in the reference's chain; fp32
# inputs (the trainers'): by the order of sums only (relative L2)
TRAIN_GRAD_REL_TOL = 4e-3
TRAIN_GRAD_FP32_REL_TOL = 1e-5
# one STT step in fp32, kernel route against the plain route on the card: the
# loss and the encoder q/k/v gradients (relative L2), which differ by the
# attention forward's order of sums, carried through two layers and back
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_STEP_REL_TOL = 1e-3
TRAIN_STEPS = 30  # steps per trainer on its pool
# the mean loss of a trainer's last 5 steps must be below this share of its
# first step's loss, on a pool of 2 batches (a run that learns nothing fails)
TRAIN_FALL = {"tiny_stt": 0.8, "tiny_tts": 0.8, "vocoder": 0.95, "tiny_llm": 0.8,
              "vad": 0.95, "amendnet": 0.98}
TRAIN_SEED = 21


def rel_l2_t(torch, got, want) -> float:
    return float(torch.linalg.vector_norm((got.float() - want.float()).flatten())
                 / torch.linalg.vector_norm(want.float().flatten()).clamp_min(1e-30))


def train_attention_grads(torch, attn) -> list:
    """``KernelAttention`` (the kernel's forward, the reference's backward)
    against fp32 autograd of the plain attention on the same inputs: fp32
    (the trainers' dtype, the kernel's fp32 mode) at whisper-large-v3's
    width (``[2, 1500, 1280]``, 20 heads) and at the tiny STT's (``[4,
    250, 256]``, 4 heads), each with and without a key mask, and bf16 at
    large-v3 width; the forward and the backward timed at large-v3 width
    in both dtypes."""
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    cases = []
    for dt, B, S, H, masked in ((torch.float32, 2, 1500, 20, False),
                                (torch.float32, 2, 1500, 20, True),
                                (torch.float32, 4, 250, 4, False),
                                (torch.float32, 4, 250, 4, True),
                                (torch.bfloat16, 2, 1500, 20, False)):
        fp32 = dt == torch.float32
        q, k, v = (torch.randn((B, S, H * 64), generator=g, device="cuda")
                   .to(dt).requires_grad_() for _ in range(3))
        gout = torch.randn((B, S, H * 64), generator=g, device="cuda").to(dt)
        mask = None
        if masked:
            lens = torch.randint(S // 2, S + 1, (B,), generator=g, device="cuda")
            mask = torch.arange(S, device="cuda")[None] < lens[:, None]
        before = launch_counts()
        out = attn.fused_attention(q, k, v, n_heads=H, mask=mask)
        moved = {m: n - before[m] for m, n in launch_counts().items() if n != before[m]}
        check(out.grad_fn is not None and moved == {ATTN_KEY[fp32]: 1},
              f"train: attention under grad made no autograd node or launched {moved}")
        grads = torch.autograd.grad(out, (q, k, v), gout, retain_graph=True)
        ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
        ref = attn.by_heads(attn._plain_attention, *ref_in, n_heads=H, mask=mask)
        ref_grads = torch.autograd.grad(ref, ref_in, gout.float(), retain_graph=True)
        torch.cuda.synchronize()
        case = {"dtype": str(dt).replace("torch.", ""), "B": B, "S": S, "heads": H,
                "masked": masked, "out_max_abs_err": (out.float() - ref).abs().max().item(),
                "out_rel_l2": rel_l2_t(torch, out, ref),
                **{f"d{n}_rel_l2": rel_l2_t(torch, a, b)
                   for n, a, b in zip("qkv", grads, ref_grads)}}
        if B == 2 and not masked:  # the timed cases, large-v3 width
            def fwd():
                with torch.no_grad():
                    attn.fused_attention(q, k, v, n_heads=H)
            case["forward_ms"] = cuda_ms(fwd, 10)
            case["backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out, (q, k, v), gout, retain_graph=True), 10)
            case["plain_fp32_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
                ref, ref_in, gout.float(), retain_graph=True), 5)
        cases.append(case)
        tol = TRAIN_GRAD_FP32_REL_TOL if fp32 else TRAIN_GRAD_REL_TOL
        for n in "qkv":
            err = case[f"d{n}_rel_l2"]
            check(math.isfinite(err) and err <= tol,
                  f"train: d{n} at {dt} {B}x{S}x{H * 64} masked={masked}: rel L2 {err}")
        check(case["out_rel_l2"] <= ATTN_FP32_REL_TOL if fp32
              else case["out_max_abs_err"] <= ATTN_TOL,
              f"train: attention forward error {case}")
        del out, ref, grads, ref_grads
    return cases


def pool_of(make, seeds):
    """Batches made in threads, one numpy generator per seed (the host's
    synthesis releases the GIL in scipy and numpy)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as ex:
        return list(ex.map(lambda s: make(np.random.default_rng(s)), seeds))


def run_trainer(torch, name: str, train, steps: int = TRAIN_STEPS) -> dict:
    """``train(steps) -> losses``, timed: the first step (the build of every
    kernel and plan) apart from the rest."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = train(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first, last = losses[0], float(np.mean(losses[-5:]))
    check(all(math.isfinite(x) for x in losses), f"train {name}: a loss is not finite")
    check(last < TRAIN_FALL[name] * first,
          f"train {name}: loss {first:.4f} -> {last:.4f}, not below "
          f"{TRAIN_FALL[name]} of its start")
    return {"steps": steps, "first_loss": first, "last5_loss": last,
            "fall": last / first, "wall_s": wall, "losses": [round(x, 5) for x in losses]}


def train_stt_step_routes(torch, attn, tr, optim, params, cfg, batch) -> dict:
    """One STT step's loss and encoder q/k/v gradients through the kernel
    (``KernelAttention``) and through the plain attention on the card."""
    from infernos_tpu_torch.models import whisper as wsp

    leaves = [params["enc_layers"]["attn"][n]["w"] for n in "qkv"]

    def step(route):
        with contextlib.ExitStack() as st:
            if route is not None:
                st.enter_context(mock.patch.object(wsp, "fused_attention", route))
            loss, _ = tr.loss_fn(params, cfg, *batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach().float(), grads

    def plain(q, k, v, *, n_heads, mask=None):
        return attn.by_heads(attn._plain_attention, q, k, v, n_heads=n_heads, mask=mask)

    before = attn.fused_attention.launches_fp32
    loss_k, g_k = step(None)
    launches = attn.fused_attention.launches_fp32 - before
    loss_p, g_p = step(plain)
    check(attn.fused_attention.launches_fp32 - before == launches,
          "train: the plain route launched the kernel")
    check(launches == cfg.encoder_layers,
          f"train: one STT step launched kernel 1 {launches} times, want "
          f"{cfg.encoder_layers} (one per encoder layer)")
    out = {"kernel_launches": launches, "loss_kernel": float(loss_k),
           "loss_plain": float(loss_p),
           "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))}
    for n, a, b in zip("qkv", g_k, g_p):
        for layer in range(cfg.encoder_layers):
            check(bool(torch.isfinite(a[layer]).all()) and a[layer].abs().sum().item() > 0,
                  f"train: encoder layer {layer} {n} weight got no finite nonzero gradient")
        out[f"d{n}_rel_l2"] = rel_l2_t(torch, a, b)
        check(out[f"d{n}_rel_l2"] <= TRAIN_STEP_REL_TOL,
              f"train: the kernel route's {n} gradient is {out[f'd{n}_rel_l2']} from the plain's")
    check(out["loss_rel_err"] <= TRAIN_LOSS_REL_TOL,
          f"train: the kernel route's loss {loss_k} vs the plain route's {loss_p}")
    return out


@contextlib.contextmanager
def data_override(name: str, path: str):
    key = f"INFERNOS_TINY_DATA_{name.upper()}"
    old = os.environ.get(key)
    os.environ[key] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def phase_train(torch, attn):
    """Phase ``train``: (a) ``KernelAttention``'s gradients against fp32
    autograd of the plain attention on the card, large-v3 and tiny widths;
    (b) one tiny STT training step through the kernel against the same
    step through the plain attention (2 launches a step); (c) every trainer
    (STT, SpeechT5, HiFi-GAN, LLM, VAD, AmendNet) for ``TRAIN_STEPS`` steps on
    a pool of two pre-built batches, its loss finite and falling, its
    checkpoint saved under ``infernos_tpu_torch/build/trained`` and served
    once through the port's loaders.  fp32 throughout, as the reference
    trains.  Returns kernel 1's fp32 launches in the STT trainer's run
    (counted from 0 before it)."""
    from infernos_tpu_torch.models import amendnet, qwen, tiny_real, vad
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.serving import stt_engine as stt
    from infernos_tpu_torch.serving import tts_engine as tts
    from infernos_tpu_torch.tools import optim
    from infernos_tpu_torch.tools import train_amendnet as tr_amd
    from infernos_tpu_torch.tools import train_tiny_llm as tr_llm
    from infernos_tpu_torch.tools import train_tiny_stt as tr_stt
    from infernos_tpu_torch.tools import train_tiny_tts as tr_tts
    from infernos_tpu_torch.tools import train_vad as tr_vad
    from infernos_tpu_torch.utils.platform import card_info

    t_phase = time.perf_counter()
    grads = train_attention_grads(torch, attn)
    dev = "cuda"

    def gen():
        return torch.Generator().manual_seed(TRAIN_SEED)

    out, served = {}, {}
    seeds = (TRAIN_SEED, TRAIN_SEED + 1)
    t0 = time.perf_counter()
    stok, ttok = tr_stt.build_tokenizer(), tr_tts.build_tokenizer()
    speakers = tr_tts.speaker_bank()
    stt_pool = pool_of(lambda r: tr_stt.make_batch(r, stok, 8), seeds)
    tts_ex = pool_of(lambda r: [tr_tts.make_example(r, ttok, speakers) for _ in range(4)], seeds)
    tts_pool = [tr_tts.assemble(e) for e in tts_ex]
    voc_pool = [tr_tts.voc_batch(np.random.default_rng(s), e) for s, e in zip(seeds, tts_ex)]
    llm_pool = pool_of(lambda r: tr_llm.make_batch(r, tr_llm.ByteTokenizer(), 8), seeds)
    vcfg_vad, acfg = vad.VADConfig(), amendnet.AmendNetConfig()
    vad_pool = pool_of(lambda r: tr_vad.make_batch(r, 16, 12, vcfg_vad.window), seeds)
    amd_pool = pool_of(lambda r: tr_amd.make_batch(r, 32, acfg), seeds)
    pools_s = time.perf_counter() - t0

    # (b) one STT step, kernel route against plain route
    scfg = tr_stt.tiny_config(stok)
    sparams = optim.trainable(wsp.init_params(scfg, gen(), dev))
    routes = train_stt_step_routes(torch, attn, tr_stt, optim, sparams, scfg,
                                   optim.to_device(stt_pool[0], dev))

    # (c) each trainer on its pool, saved and served
    opt = tr_stt.make_optimizer(sparams, 3e-4, TRAIN_STEPS)
    reset_launch_counts()
    out["tiny_stt"] = run_trainer(torch, "tiny_stt", lambda n: tr_stt.train(
        sparams, scfg, opt, lambda i: stt_pool[i % 2], n, dev, log_every=0))
    train_launches = path_launches(launch_counts(), "train", fp32=True)[0]
    check(train_launches == scfg.encoder_layers * TRAIN_STEPS,
          f"train: the STT trainer launched kernel 1 {train_launches} times in "
          f"{TRAIN_STEPS} steps")
    path = optim.default_out("tiny_stt")
    tr_stt.save(path, sparams, scfg, stok)
    with data_override("tiny_stt", path):
        p, c, tok, ecfg = tiny_real.load_tiny_stt(dev)
    check(p["enc_layers"]["attn"]["q"]["w"].dtype == torch.float32, "train: STT not fp32")
    eng = stt.STTEngine(p, c, ecfg, detokenize=tok.detokenize, device=dev)
    got = []
    audio, _ = tr_stt.make_utterance(np.random.default_rng(3), n_words=(2, 3), lang="en")
    eng.submit(stt.STTRequest(audio=audio, text_cb=got.append, lang="en"))
    while eng.step():
        pass
    check(len(got) == 1, "train: the retrained STT did not answer")
    served["tiny_stt"] = {"tokens": len(got[0].tokens), "text": got[0].text}

    tcfg = tr_tts.tiny_config(ttok.vocab_size)
    tparams = optim.trainable(tr_tts.init_t5(tcfg, TRAIN_SEED, dev))
    topt = tr_tts.t5_optimizer(tparams, 3e-4, TRAIN_STEPS)
    out["tiny_tts"] = run_trainer(torch, "tiny_tts", lambda n: tr_tts.train_t5(
        tparams, tcfg, topt, lambda i: tts_pool[i % 2], n, dev, TRAIN_SEED, log_every=0))
    vcfg = tr_tts.voc_config()
    vparams = optim.trainable(tr_tts.init_vocoder(
        vcfg, TRAIN_SEED, [x for e in tts_ex for x in e], dev))
    vopt = tr_tts.voc_optimizer(vparams, 2e-4, TRAIN_STEPS)
    out["vocoder"] = run_trainer(torch, "vocoder", lambda n: tr_tts.train_vocoder(
        vparams, vcfg, vopt, lambda i: voc_pool[i % 2], n, dev, log_every=0))
    path = tr_tts.save_common(optim.default_out("tiny_tts"), ttok)
    tr_tts.save_t5(path, tparams, tcfg)
    tr_tts.save_vocoder(path, vparams, vcfg)
    with data_override("tiny_tts", path):
        tp, tc, vp, vc, tk, table = tiny_real.load_tiny_tts("hifigan", dev)
    check(table.shape == (tr_tts.N_SPEAKERS, tr_tts.SPK_DIM), "train: speaker table")
    teng = tts.TTSEngine(tp, tc, vp, vc, tts.TTSEngineConfig(
        batch_slots=1, max_text_tokens=48, max_steps=32, stop_threshold=0.5,
        dtype=torch.float32), device=dev)
    chunks, done = [], []
    teng.start_session(np.asarray(tk("hello now"), np.int32), table[0],
                       lambda a: done.append(1) if a is None else chunks.append(a))
    for _ in range(200):
        teng.step()
        if done:
            break
    check(bool(done) and chunks and all(np.isfinite(c).all() for c in chunks),
          "train: the retrained TTS said nothing finite")
    served["tiny_tts"] = {"chunks": len(chunks), "samples": int(sum(len(c) for c in chunks))}

    lcfg = tr_llm.tiny_config()
    lparams = optim.trainable(qwen.init_params(lcfg, gen(), dev))
    lopt = tr_llm.make_optimizer(lparams, 3e-4, TRAIN_STEPS)
    out["tiny_llm"] = run_trainer(torch, "tiny_llm", lambda n: tr_llm.train(
        lparams, lcfg, lopt, lambda i: llm_pool[i % 2], n, dev, log_every=0))
    path = optim.default_out("tiny_llm")
    tr_llm.save(path, lparams, lcfg)
    with data_override("tiny_llm", path):
        lp, lc = tiny_real.load_tiny_llm(dev)
    reply = tr_llm.greedy_replies(lp, lc, tr_llm.ByteTokenizer(),
                                  [[{"role": "user", "content": "hello good morning"}]],
                                  max_new=8, device=dev)
    served["tiny_llm"] = {"reply": reply[0]}

    vdp = optim.trainable(vad.init_params(vcfg_vad, gen(), dev))
    out["vad"] = run_trainer(torch, "vad", lambda n: tr_vad.train(
        vdp, vcfg_vad, tr_vad.make_optimizer(vdp, 1e-3), lambda i: vad_pool[i % 2], n, dev,
        log_every=0))
    wv = vad.load_pretrained(dev, tr_vad.save(optim.default_out("vad"), vdp))
    probs = vad.NeuralVAD(wv, vcfg_vad, 2, device=dev)(vad_pool[0][0][:2, 0])
    check(np.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all(),
          "train: the retrained VAD gave no probabilities")
    served["vad"] = {"probs": probs.tolist()}

    amp = optim.trainable(amendnet.init_params(acfg, gen(), dev))
    out["amendnet"] = run_trainer(torch, "amendnet", lambda n: tr_amd.train(
        amp, acfg, tr_amd.make_optimizer(amp, 3e-4), lambda i: amd_pool[i % 2], n, dev,
        log_every=0))
    wa = amendnet.load_pretrained(dev, path=tr_amd.save(optim.default_out("amendnet"), amp))
    mel, dirty, _ = optim.to_device(amd_pool[0], dev)
    amended = amendnet.apply(wa, acfg, mel[:2], dirty[:2])
    check(bool(torch.isfinite(amended).all()), "train: the retrained AmendNet is not finite")
    served["amendnet"] = {"samples": int(amended.shape[1])}

    emit("train", card=card_info(), tol=TRAIN_GRAD_REL_TOL, fp32_tol=TRAIN_GRAD_FP32_REL_TOL,
         step_tol=TRAIN_STEP_REL_TOL, loss_tol=TRAIN_LOSS_REL_TOL,
         precision="fp32 parameters, AdamW state and forward, as the reference trains",
         attention=grads, stt_step_routes=routes, pools_s=pools_s,
         trainers={k: {**v, "step_ms": 1e3 * v["wall_s"] / v["steps"]} for k, v in out.items()},
         served=served, stt_train_kernel_launches=train_launches,
         wall_s=time.perf_counter() - t_phase)
    return train_launches


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
    ``fused_attention`` call at the encoder's shape in bf16 and in fp32
    (want 1: the kernel), of the bf16 kernel behind a head split, of one
    ``fused_decode_step`` call at full width in each mode (``step_calls``:
    the step phases' own calls; want 1 each), of one ``cross_attention_i8``
    call at large-v3's decode step, masked (want 1), and of one
    ``whisper.encode``.
    It runs last: once the profiler has been on, every later launch of the
    process costs the host more, which would spoil the phases' host clocks."""
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn((1, 1500, 1280), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    out = {"fused_attention": device_launches(
               torch, lambda: attn.fused_attention(q, k, v, n_heads=20)),
           "fused_attention_fp32": device_launches(
               torch, lambda: attn.fused_attention(q32, k32, v32, n_heads=20)),
           "split_heads": device_launches(
               torch, lambda: attn.by_heads(attn._kernel_attention, q, k, v,
                                            n_heads=20))}
    for mode, fn in (step_calls or {}).items():
        out[f"fused_decode_step_{mode}"] = device_launches(torch, fn)
    from infernos_tpu_torch.ops import cross_attention_i8 as xi8

    cq, ck, cv, cmask = cross_i8_case(torch, g, *CROSS_I8_MAIN, torch.bfloat16, True)
    out["cross_attention_i8"] = device_launches(
        torch, lambda: xi8.cross_attention_i8(cq, ck, cv, cmask))
    # one decode dispatch (K steps) of the tiny-real LLM engine: its
    # kernels per layer and step are those of any Qwen config
    from infernos_tpu_torch.models import tiny_real
    from infernos_tpu_torch.serving.llm_engine import LLMEngine, LLMEngineConfig

    params, cfg = tiny_real.load_tiny_llm("cuda")
    ecfg = LLMEngineConfig(batch_slots=4, prompt_buckets=(128,), max_total_tokens=448,
                           max_new_tokens=64, dtype=torch.float32)
    eng = LLMEngine(params, cfg, ecfg, device="cuda")
    with torch.no_grad():
        out["llm_decode_dispatch"] = device_launches(torch, eng._step)
    out["llm_dispatch_steps"], out["llm_layers"] = ecfg.steps_per_dispatch, cfg.num_layers
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
    for name in ("fused_attention", "fused_attention_fp32", "cross_attention_i8"):
        check(out[name] == 1, f"{name} ran {out[name]} kernels and copies "
                              f"on the card, want its kernel alone")
    for mode in step_calls or {}:
        n = out[f"fused_decode_step_{mode}"]
        check(n == 1, f"fused_decode_step ({mode}) ran {n} kernels and copies "
                      f"on the card, want the step kernel alone")


# the phases ``--only benches`` runs, in order (``--phases`` picks some)
BENCH_PHASES = {
    "paced_tts": lambda torch, attn: phase_paced_tts(torch),
    "lt_bench_tiny": lambda torch, attn: phase_lt_bench_tiny(torch),
    "lt_ramp": lambda torch, attn: phase_lt_ramp(torch),
    "loopback": lambda torch, attn: phase_loopback(torch),
    "stt_ladder": lambda torch, attn: phase_stt_ladder(torch, attn),
    "sttbench": lambda torch, attn: phase_sttbench(torch),
    "ttsbench": lambda torch, attn: phase_ttsbench(torch),
    "ttsprobe": lambda torch, attn: phase_ttsprobe(torch),
    "llmbench": lambda torch, attn: phase_llmbench(torch),
    "aia_bench": lambda torch, attn: phase_aia_bench(torch),
    "echo": lambda torch, attn: phase_echo(torch),
    "ramp_profile": lambda torch, attn: phase_ramp_profile(torch),
    "ckpt_port": lambda torch, attn: phase_ckpt_port(torch, attn),
}


def _remote_call_alone(torch, attn):
    from infernos_tpu_torch.ops import tts_step as ts

    return phase_remote_call(torch, attn, ts)


def _cross_i8_alone(torch, attn):
    phase_cross_i8(torch)
    _, params, results = phase_stt(torch, attn)
    phase_stt_cross_i8(torch, params, results)


# the phases ``--phases`` runs alone after the build
ALONE_PHASES = {**BENCH_PHASES, "remote_call": _remote_call_alone, "cross_i8": _cross_i8_alone,
                "parallel": lambda torch, attn: phase_parallel(torch),
                "examples": lambda torch, attn: phase_examples(torch),
                "train": phase_train}


def main(argv=None) -> int:
    global CKPT_SEED
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile the engine runs; kernel tables go to DIR")
    ap.add_argument("--only", choices=["attention", "kernels", "benches"],
                    help="stop after the attention kernel's phase, or after "
                         "all kernel phases, or run the bench phases (and "
                         "stt_ladder, ckpt_port) alone after the build (prints no "
                         "result line)")
    ap.add_argument("--phases", metavar="NAME,...",
                    help="run only these of the bench phases, stt_ladder, ckpt_port, "
                         "remote_call, cross_i8 (kernel_cross_i8, stt, stt_cross_i8), "
                         "parallel, examples and train, in the order given, after "
                         "the build "
                         "(prints no result line): " + ", ".join(ALONE_PHASES))
    ap.add_argument("--ckpt-seed", type=int, default=CKPT_SEED,
                    help="the generator seed of ckpt_port's HF-layout weights "
                         f"(default {CKPT_SEED})")
    args = ap.parse_args(argv)
    CKPT_SEED = args.ckpt_seed
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
    # the cluster kernel's shared memory (dynamic, from its plan) and how many
    # of its clusters the card holds at once, at the tiny-real and full widths
    cluster = {}
    for what, (B, D, F, L) in (("tiny_real", (8, 256, 768, 3)), ("full", (8, 768, 3072, 6))):
        for int8w in (False, True):
            plan = ts.cluster_plan(B, D, F, L, int8w)
            active = ctypes.c_int()
            rc = build.load("tts_step_cluster").tts_step_cluster_max_active(
                plan["csize"], plan["smem_bytes"], int(int8w), ctypes.byref(active))
            check(rc == 0 and active.value >= 1,
                  f"cluster kernel at {what}: {active.value} clusters of {plan['csize']} "
                  f"blocks fit (cudaError_t {rc})")
            cluster[f"{what}_{'int8' if int8w else 'bf16'}"] = {
                "smem_bytes": plan["smem_bytes"], "csize": plan["csize"],
                "clusters_per_step": plan["clusters"], "max_active_clusters": active.value,
                "nslot": plan["nslot"], "slot_bytes": plan["slot_bytes"]}
    emit("build", seconds=time.perf_counter() - t0, sources=list(build.SOURCES),
         attention_sass=sass, tts_step_sass=step_sass,
         tts_step_cluster_sass=sass_summary(build, "tts_step_cluster"),
         ptxas={n: ptxas_summary(build.LOGS.get(n, "")) for n in build.SOURCES},
         cluster_plans=cluster)
    check(sass is None or sass["HGMMA"] > 0,
          "the attention library holds no warpgroup product (HGMMA)")
    check(step_sass is None or step_sass["HMMA"] > 0,
          "the decoder-step library holds no tensor-core product (HMMA)")

    if args.only == "benches" or args.phases:
        names = args.phases.split(",") if args.phases else list(BENCH_PHASES)
        check(set(names) <= set(ALONE_PHASES), f"--phases: unknown {names}")
        for name in names:
            ALONE_PHASES[name](torch, attn)
        return 0
    kernels = [phase_attention(torch, attn), phase_attention_fp32(torch, attn)]
    if args.only == "attention":
        phase_device_launches(torch, attn)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0
    step_calls, bf16_ms = {}, None
    for int8, fp32 in ((False, False), (True, False), (False, True), (True, True)):
        row, call = phase_tts_step(torch, st5, ts, int8=int8, fp32=fp32, bf16_ms=bf16_ms)
        kernels.append(row)
        step_calls[STEP_KEY[(int8, fp32)]] = call
        bf16_ms = bf16_ms if bf16_ms is not None else row["ms"]
    kernels.append(phase_cross_i8(torch))
    if args.only == "kernels":
        phase_device_launches(torch, attn, step_calls)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0
    stt_launches, stt_params, stt_results = phase_stt(torch, attn, args.profile)
    cross_launches = phase_stt_cross_i8(torch, stt_params, stt_results)
    tts_launches = phase_tts(torch, ts, args.profile)
    wide_launches = tts_engine_wide(torch, ts)
    turn_attn, turn_int8, turn_bf16 = phase_turn(torch, attn, ts, stt_params)
    call_attn, call_fp32 = phase_rtp_call(torch, attn, ts)
    sip_attn, sip_fp32, sip_reply = phase_sip_call(torch, attn, ts)
    rem_full_attn, rem_attn, rem_fp32 = phase_remote_call(torch, attn, ts, sip_reply)
    dmn_attn, dmn_bf16 = phase_daemon(torch)
    phase_llm(torch)
    phase_llm_tiny(torch)
    aia_attn, aia_fp32 = phase_aia_call(torch, attn, ts)
    daia_attn, daia_bf16 = phase_daemon_aia(torch)
    paced_bf16 = phase_paced_tts(torch)
    ltt_attn, ltt_fp32 = phase_lt_bench_tiny(torch)
    ramp_attn, ramp_bf16 = phase_lt_ramp(torch)
    loop_attn, loop_fp32 = phase_loopback(torch)
    ladder_attn = phase_stt_ladder(torch, attn, stt_params)
    sttb_attn = phase_sttbench(torch)
    ttsb_bf16 = phase_ttsbench(torch)
    probe_bf16 = phase_ttsprobe(torch)
    phase_llmbench(torch)
    par = phase_parallel(torch)
    aiab_attn, aiab_fp32 = phase_aia_bench(torch)
    echo_attn, echo_fp32 = phase_echo(torch)
    prof_attn, prof_bf16 = phase_ramp_profile(torch)
    ckpt_attn, ckpt_bf16, ckpt_int8 = phase_ckpt_port(torch, attn)
    examples_bf16 = phase_examples(torch)
    train_attn = phase_train(torch, attn)
    phase_device_launches(torch, attn, step_calls, stt_params)
    # each path was driven with the counts at 0 before it and read after it
    # (the daemons' calls and the LT benches' levels in their own
    # processes, apart from their warm-ups; the paced TTS and loopback
    # benches' whole runs in theirs; remote_call's kernel-1 launches in
    # its peer), and held to its modes: the full-width engines to the bf16
    # ones, the tiny and tiny-real engines (and the trainers) to the fp32
    # ones, as the reference runs them
    by_mode = {
        "encoder_attention": {
            "stt": stt_launches, "turn": turn_attn, "remote_call_full": rem_full_attn,
            "daemon": dmn_attn, "daemon_aia": daia_attn, "lt_ramp": ramp_attn,
            "stt_ladder": ladder_attn, "sttbench": sttb_attn, "ramp_profile": prof_attn,
            "ckpt_port": ckpt_attn},
        "encoder_attention_fp32": {
            "rtp_call": call_attn, "sip_call": sip_attn, "remote_call": rem_attn,
            "aia_call": aia_attn, "lt_bench_tiny": ltt_attn, "loopback": loop_attn,
            "aia_bench": aiab_attn, "echo": echo_attn, "train": train_attn,
            **{f"parallel_{k}": v["stt"]["attention_fp32"] for k, v in par.items()}},
        "tts_decode_step": {
            "tts": tts_launches, "daemon": dmn_bf16, "daemon_aia": daia_bf16,
            "paced_tts": paced_bf16, "lt_ramp": ramp_bf16, "ttsbench": ttsb_bf16,
            "ttsprobe": probe_bf16, "ramp_profile": prof_bf16, "ckpt_port": ckpt_bf16,
            "examples": examples_bf16},
        "tts_decode_step_int8": {"turn": turn_int8, "ckpt_port_int8": ckpt_int8},
        "tts_decode_step_fp32": {
            "tts_40_slots": wide_launches, "rtp_call": call_fp32, "sip_call": sip_fp32,
            "remote_call": rem_fp32, "aia_call": aia_fp32, "lt_bench_tiny": ltt_fp32,
            "loopback": loop_fp32, "aia_bench": aiab_fp32, "echo": echo_fp32,
            **{f"parallel_{k}": v["tts"]["fp32_step"] for k, v in par.items()}},
        # no engine of the main path runs int8 weights over fp32 caches: the
        # mode is held to its plain version above and has no path here
        "tts_decode_step_int8_fp32": {},
        # opt-in (STTEngineConfig.cross_int8_direct): every other path holds 0
        "cross_attention_i8": {"stt_cross_i8": cross_launches},
    }
    check(turn_bf16 == 0, f"turn: the bf16 step kernel launched {turn_bf16} times")
    for row in kernels:
        by_path = by_mode[row["name"]]
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        check(not by_path or all(n > 0 for n in by_path.values()),
              f"{row['name']}: a path of its mode launched it no time: {by_path}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
