"""Where the decoder-step kernel's time goes: timing experiments.

    python -m infernos_tpu_torch.ops.tts_step_ablate

Builds ``csrc/tts_step.cu`` seven times: whole, with the products compiled
out (``-DTTS_ABLATE_GEMM``: no weight copies, no products, no partial
sums), with the attention phases compiled out (``-DTTS_ABLATE_ATTN``),
with both out (what is left is the 48 grid barriers and the last
LayerNorm), with the weight copies out (``-DTTS_ABLATE_COPY``: the
products read whatever the ring holds), and with ``-DTTS_TRACE``, alone
and with the copies out: one step's clock64() at the points of every phase
of every block, summed up per phase kind by :func:`trace_summary`.  Each
build is timed at the main path's shape (SpeechT5 width,
B 8, T 512, S 96, pos 256) in both weight modes, and the whole build also
with a weight ring of 1 and 2 slots instead of the plan's (how much the
copies ahead of each product save) and with two other plans: the
smallest items (``step_plan(max_tiles=None)``, the most K splits) and items
of at most 96 tiles.  The whole build is timed again at 12 to 32 slots
(the same inputs repeated) under caps of 96, 64, 48 and 32 tiles (null
where two ring slots of such items do not fit) and the smallest items,
beside the plan the wrapper takes there.  The ablated builds compute wrong
results on purpose; only their times mean anything.  Needs an NVIDIA card
(sm_90a) and ``nvcc``; prints one JSON line, device microseconds per step
(20 steps captured in one CUDA graph, the replay timed with CUDA events).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from ..models import speecht5 as st5
from ..models.quant import quantize_params
from . import build
from . import tts_step as ts

PHASES = ("qkv", "self_attn", "so", "cq", "cross_attn", "co", "w1", "w2")
POINTS = ("start", "x_staged", "weights_in", "products", "partials_out", "split_sums",
          "ln_sums", "end")
VARIANTS = {
    "whole": [],
    "trace": ["-DTTS_TRACE"],
    "no_gemm": ["-DTTS_ABLATE_GEMM"],
    "no_attn": ["-DTTS_ABLATE_ATTN"],
    "barriers_only": ["-DTTS_ABLATE_GEMM", "-DTTS_ABLATE_ATTN"],
    "no_copy": ["-DTTS_ABLATE_COPY"],
    "trace_no_copy": ["-DTTS_TRACE", "-DTTS_ABLATE_COPY"],
}


def _time_us(step, iters: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the capture stream's scratch, attributes,
        step()  # allocator: outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            step()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (5 * iters) * 1e3


def trace_summary(tr: torch.Tensor, Lyr: int) -> dict:
    """Per phase kind, averaged over the layers: the phase's wall time
    (start to the next phase's start, median over blocks), the longest
    block's own work (start to its arrival at the barrier) and, for the
    products, the longest block's time to each point (``POINTS``).  ``tr``
    is the ``[grid, 8 L + 1, 8]`` clock64() trace of one step."""
    last = tr[:, 8 * Lyr].double()
    ghz = float(((last[:, 2] - last[:, 1]) / (last[:, 4] - last[:, 3])).median())
    t = tr.tolist()
    out = {"sm_clock_ghz": ghz, "step_us": float((last[:, 4] - last[:, 3]).max()) / 1e3}
    us = lambda cycles: cycles / ghz / 1e3
    for k, name in enumerate(PHASES):
        walls, works, segs = [], [], {n: [] for n in POINTS[1:7]}
        for l in range(Lyr):
            ph = 8 * l + k
            walls.append(sorted(us(b[ph + 1][0] - b[ph][0]) for b in t)[len(t) // 2])
            works.append(max(us(b[ph][7] - b[ph][0]) for b in t))
            seg = {n: 0.0 for n in POINTS[1:7]}
            for b in t:
                prev = b[ph][0]
                for j in range(1, 7):
                    if b[ph][j]:
                        seg[POINTS[j]] = max(seg[POINTS[j]], us(b[ph][j] - prev))
                        prev = b[ph][j]
            for n in seg:
                segs[n].append(seg[n])
        out[name] = {"wall_us": sum(walls) / Lyr, "work_max_us": sum(works) / Lyr}
        if "attn" not in name:
            out[name]["segment_max_us"] = {n: sum(v) / Lyr for n, v in segs.items()}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tts_step_ablate: no CUDA device", file=sys.stderr)
        return 1
    out_dir = os.path.join(build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(build.CSRC_DIR, "tts_step.cu")
    procs = {n: subprocess.Popen(
        build.nvcc_command(src, os.path.join(out_dir, f"libtts_{n}.so"), flags),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, flags in VARIANTS.items()}
    cfg = st5.SpeechT5Config()
    g = torch.Generator(device="cuda").manual_seed(9)
    dense = st5.init_params(cfg, g, "cuda", torch.bfloat16)
    trees = {"bf16": dense, "int8": quantize_params(dense)}
    B, T, S = 8, 512, 96
    Lyr, H, Dh, D, F = (cfg.decoder_layers, cfg.decoder_attention_heads, cfg.head_dim,
                        cfg.hidden_size, cfg.decoder_ffn_dim)

    def inputs(B):
        """x, caches, pos 256 and the ragged mask of B slots."""
        cache = st5.DecoderCache(*(torch.randn((Lyr, B, H, n, Dh), generator=g,
                                               device="cuda").to(torch.bfloat16)
                                   for n in (T, T, S, S)))
        x = torch.randn((B, 1, D), generator=g, device="cuda").to(torch.bfloat16)
        pos = torch.full((B,), 256, dtype=torch.long, device="cuda")
        lens = torch.tensor([96, 1, 50, 96, 17, 80, 96, 33], device="cuda")[
            torch.arange(B, device="cuda") % 8]
        return x, cache, pos, torch.arange(S, device="cuda")[None] < lens[:, None]

    x, cache, pos, enc_mask = inputs(B)
    grid = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"device": torch.cuda.get_device_name(0), "B": B, "T": T, "S": S,
              "pos": 256, "us": {}, "whole_us_by_slots": {},
              "whole_us_by_plan": {}, "whole_us_by_batch": {}, "plans": {}}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"libtts_{n}.so"))
        for mode, tree in trees.items():
            fn = lib.tts_decode_step_int8 if mode == "int8" else lib.tts_decode_step
            fw = ts.pack_fused_weights(tree, cfg, torch.bfloat16)
            ts._check_step_args(fw, x, cache, pos, enc_mask)
            plan = ts.step_plan(B, D, F, mode == "int8", grid)
            step = lambda plan=plan, fw=fw, fn=fn: ts._launch(fn, fw, cfg, x, cache, pos,
                                                       enc_mask, plan)
            if n.startswith("trace"):
                tr = torch.zeros((grid, 8 * Lyr + 1, 8), dtype=torch.int64, device="cuda")
                for _ in range(3):
                    ts._launch(fn, fw, cfg, x, cache, pos, enc_mask, plan, trace=tr)
                torch.cuda.synchronize()
                result.setdefault(n, {})[mode] = trace_summary(tr.cpu(), Lyr)
                continue
            result["us"][f"{n}_{mode}"] = _time_us(step)
            if n == "whole":
                for cap in (None, 96):  # the smallest items; a higher cap
                    other = ts.step_plan(B, D, F, mode == "int8", grid, max_tiles=cap)
                    step = lambda plan=other, fw=fw, fn=fn: ts._launch(
                        fn, fw, cfg, x, cache, pos, enc_mask, plan)
                    result["whole_us_by_plan"][f"max_tiles_{cap}_{mode}"] = _time_us(step)
                    result["plans"][f"max_tiles_{cap}_{mode}"] = ts.plan_ints(other)
                result["plans"][f"default_{mode}"] = ts.plan_ints(plan)
                for nslot in (1, 2):
                    small = dict(plan, nslot=nslot, smem_bytes=plan["smem_bytes"]
                                 - (plan["nslot"] - nslot) * plan["slot_bytes"])
                    step = lambda plan=small, fw=fw, fn=fn: ts._launch(
                        fn, fw, cfg, x, cache, pos, enc_mask, plan)
                    result["whole_us_by_slots"][f"{nslot}_{mode}"] = _time_us(step)
                result["whole_us_by_slots"][f"{plan['nslot']}_{mode}"] = \
                    result["us"][f"whole_{mode}"]
                for nb in (12, 16, 20, 24, 32):  # up to the benches' 24 and beyond
                    args = inputs(nb)
                    ts._check_step_args(fw, *args)
                    result["plans"][f"default_B{nb}_{mode}"] = ts.plan_ints(
                        ts.step_plan(nb, D, F, mode == "int8", grid))
                    for cap in (96, 64, 48, 32, None):
                        key = f"B{nb}_max_tiles_{cap}_{mode}"
                        try:
                            other = ts._plan(nb, D, F, mode == "int8", grid, cap)
                        except ValueError:  # two slots of such items do not fit
                            result["whole_us_by_batch"][key] = None
                            continue
                        step = lambda plan=other, fw=fw, fn=fn, a=args: ts._launch(
                            fn, fw, cfg, *a, plan)
                        result["whole_us_by_batch"][key] = _time_us(step)
                        result["plans"][key] = ts.plan_ints(other)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
