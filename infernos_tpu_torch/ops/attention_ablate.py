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
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

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


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_ablate: no CUDA device", file=sys.stderr)
        return 1
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
