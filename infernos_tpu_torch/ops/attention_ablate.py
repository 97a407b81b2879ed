"""Where the encoder attention kernel's time goes: timing experiments.

    python -m infernos_tpu_torch.ops.attention_ablate

Builds ``csrc/attention.cu`` several times, each with parts compiled out
(``-DATTN_ABLATE_PRODUCTS``: both wgmma products, ``-DATTN_ABLATE_EXP``:
the exponentials, ``-DATTN_ABLATE_LOADS``: every K/V copy after the first
tile), and times each build at the encoder's shape, ``[20, 1500, 64]`` bf16
with no mask, and the whole kernel at other head counts (1 head = 12
blocks, one per SM; 11 = one block on every SM; 22 = two on every SM).
The ablated builds compute wrong results on purpose; only their times
mean anything.  Needs an NVIDIA card (sm_90a) and ``nvcc``; prints one JSON
line, times in microseconds per call (CUDA events around 100 launches).

    python -m infernos_tpu_torch.ops.attention_ablate --fp32 [--quick]

times the fp32 mode instead, at the shapes the main path gives it
(:data:`FP32_SHAPES`: the tiny-real encodes, the tiny STT trainer's step)
and whisper-large-v3's ``[20, 1500, 64]``, no mask: ``_kernel_attention``
as the wrapper launches it, as CUDA-graph replay (20 calls captured, the
replays timed with CUDA events) and eager (100 calls back to back), its
plan where the tree has ``fp32_plan``, and its relative L2 error against
the plain version.  Without ``--quick`` also the bound at the card's fp32
rate and ``scaled_dot_product_attention`` in fp32 on the same inputs; and,
where the tree has ``csrc/attention_fp32.cu``, that source built with
parts compiled out (:data:`FP32_VARIANTS`: the products, the exponentials,
the K/V copies after a block's first tile, the cluster merge) and timed
at every shape under the wrapper's plan, and the whole build under every
other plan (:func:`attention.fp32_plan` with ``rows``, ``x`` and ``split``
given; at ``[20, 1500]`` splits of 1 and 2).  ``--quick`` builds nothing and runs
in the tree of a commit before the split kernel too, so one chip call can
time parent and change in turns.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from . import attention as attn
from . import build
from .attention import HEAD_DIM, _Strides

VARIANTS = {
    "whole": [],
    "no_exp": ["-DATTN_ABLATE_EXP"],
    "no_loads": ["-DATTN_ABLATE_LOADS"],
    "no_products": ["-DATTN_ABLATE_PRODUCTS"],
    "no_products_no_exp_no_loads": ["-DATTN_ABLATE_PRODUCTS", "-DATTN_ABLATE_EXP",
                                    "-DATTN_ABLATE_LOADS"],
}

FP32_SHAPES = ((4, 100), (4, 250), (8, 250), (32, 250), (20, 1500))
FP32_VARIANTS = {
    "whole": [],
    "no_products": ["-DATTN_FP32_ABLATE_PRODUCTS"],
    "no_exp": ["-DATTN_FP32_ABLATE_EXP"],
    "no_loads": ["-DATTN_FP32_ABLATE_LOADS"],
    "no_merge": ["-DATTN_FP32_ABLATE_MERGE"],
    "no_products_no_exp_no_loads_no_merge": [
        "-DATTN_FP32_ABLATE_PRODUCTS", "-DATTN_FP32_ABLATE_EXP", "-DATTN_FP32_ABLATE_LOADS",
        "-DATTN_FP32_ABLATE_MERGE"],
}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate (as chip_smoke.py)
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores


def _time_us(fn, heads: int, S: int = 1500, iters: int = 100) -> float:
    q, k, v = (torch.randn((heads, S, HEAD_DIM), device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o = torch.empty_like(q)
    strides = _Strides(*([q.stride(0), HEAD_DIM, q.stride(1)] * 4))
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(),
                strides, heads, 1, S, HEAD_DIM ** -0.5, stream)
        build.check(rc, "attn_fwd_bf16")

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters * 1e3


def _events_us(fn, iters: int) -> float:
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters * 1e3


def _graph_us(fn, calls: int = 20, replays: int = 10) -> float:
    """Device microseconds a call: ``calls`` calls captured in one CUDA
    graph (after a warm-up on the capturing stream), the replays timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    return _events_us(graph.replay, replays) / calls


def _eager_us(fn, iters: int = 100) -> float:
    for _ in range(3):
        fn()
    return _events_us(fn, iters)


def _rel_l2(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def _fp32_entry(path: str):
    fn = ctypes.CDLL(path).attn_fwd_fp32
    fn.argtypes = attn.entry_argtypes(torch.float32)
    fn.restype = ctypes.c_int
    return fn


def _raw_call(fn, q, k, v, o, plan: dict):
    """A launch of ``fn`` (an ``attn_fwd_fp32`` of some build) on ``[BH, S,
    64]`` q, k, v into o under ``plan``."""
    BH, S = q.shape[0], q.shape[1]
    strides = _Strides(*([q.stride(0), HEAD_DIM, q.stride(1)] * 4))
    ints = attn._PlanInts(*attn.fp32_plan_ints(plan))

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), strides, BH,
                1, S, HEAD_DIM ** -0.5, ints, torch.cuda.current_stream().cuda_stream)
        build.check(rc, "attn_fwd_fp32")

    return call


def _plan_brief(plan: dict) -> dict:
    return {k: plan[k] for k in ("rows", "x", "split", "blocks", "stages", "smem_bytes")}


def fp32_main(quick: bool) -> dict:
    import torch.nn.functional as F

    from ..utils.platform import card_info

    g = torch.Generator(device="cuda").manual_seed(19)
    inputs = {s: [torch.randn((s[0], s[1], HEAD_DIM), generator=g, device="cuda")
                  for _ in range(3)] for s in FP32_SHAPES}
    has_plan = hasattr(attn, "fp32_plan")
    result = {"device": torch.cuda.get_device_name(0), "card": card_info(), "shapes": {}}
    for (BH, S), (q, k, v) in inputs.items():
        kern = lambda: attn._kernel_attention(q, k, v, None)  # noqa: E731
        row = {"rel_l2_err": _rel_l2(kern(), attn._plain_attention(
                   q, k, v, torch.zeros((BH, S), device="cuda"))),
               "graph_us": _graph_us(kern), "eager_us": _eager_us(kern)}
        if has_plan:
            row["plan"] = _plan_brief(attn.fp32_plan(BH, S))
        if not quick:
            n_bytes, n_ops = 4 * BH * S * HEAD_DIM * 4, 4.0 * BH * S * S * HEAD_DIM
            row["bound_us"] = max(n_bytes / PEAK_BYTES, n_ops / PEAK_FP32_FLOPS) * 1e6
            sdpa = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])  # noqa: E731
            row["sdpa_graph_us"], row["sdpa_eager_us"] = _graph_us(sdpa), _eager_us(sdpa)
        result["shapes"][f"[{BH}, {S}, 64]"] = row
    src = os.path.join(build.CSRC_DIR, "attention_fp32.cu")
    if quick or not os.path.exists(src):
        return result
    out_dir = os.path.join(build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    procs = {n: subprocess.Popen(
        build.nvcc_command(src, os.path.join(out_dir, f"libattention_fp32_{n}.so"), flags),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, flags in FP32_VARIANTS.items()}
    fns = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{log}")
        fns[n] = _fp32_entry(os.path.join(out_dir, f"libattention_fp32_{n}.so"))
    result["variants_graph_us"] = {n: {} for n in fns}
    result["plans_graph_us"] = {}
    for (BH, S), (q, k, v) in inputs.items():
        o = torch.empty_like(q)
        key = f"[{BH}, {S}, 64]"
        for n, fn in fns.items():
            result["variants_graph_us"][n][key] = _graph_us(
                _raw_call(fn, q, k, v, o, attn.fp32_plan(BH, S)))
        plans = {}
        for rows, x in attn.FP32_SHAPES:
            for split in attn.FP32_SPLITS:
                if split > attn.fp32_plan(BH, S)["n_kt"] or (S > 1000 and split > 2):
                    continue
                plan = attn.fp32_plan(BH, S, rows=rows, x=x, split=split)
                call = _raw_call(fns["whole"], q, k, v, o, plan)
                call()
                err = _rel_l2(o, attn._plain_attention(
                    q, k, v, torch.zeros((BH, S), device="cuda")))
                plans[f"rows {rows} x {x} split {split}"] = {
                    "blocks": plan["blocks"], "graph_us": _graph_us(call),
                    "rel_l2_err": err}
        result["plans_graph_us"][key] = plans
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_ablate: no CUDA device", file=sys.stderr)
        return 1
    if "--fp32" in sys.argv[1:]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(fp32_main("--quick" in sys.argv[1:])), flush=True)
        return 0
    out_dir = os.path.join(build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(build.CSRC_DIR, "attention.cu")
    procs = {n: subprocess.Popen(
        build.nvcc_command(src, os.path.join(out_dir, f"lib{n}.so"), flags),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, flags in VARIANTS.items()}
    result = {"device": torch.cuda.get_device_name(0), "shape": [20, 1500, HEAD_DIM],
              "us": {}, "whole_us_by_heads": {}}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{log}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"lib{n}.so")).attn_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        result["us"][n] = _time_us(fn, 20)
        if n == "whole":
            for heads in (1, 11, 20, 22, 40):
                result["whole_us_by_heads"][heads] = _time_us(fn, heads)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
