"""Where kernel 3's time goes: the int8-direct cross attention, timed.

    python -m infernos_tpu_torch.ops.cross_attention_i8_ablate [--quick | --parent]

Times ``csrc/cross_attention_i8.cu`` at whisper-large-v3's decode step,
``[16, 20, 1500, 64]`` with 16 slots of 20 heads, in two cases
(:data:`CASES`): ``main``, no mask, and ``engine``, the STT engine's own
masks (per-slot lengths :data:`ENGINE_LENS` cycled over the slots, as
``serving/stt_engine.py`` masks each slot to its bucket's encoder length;
an empty slot is masked whole and gets uniform weights).  Each case's
bound is the bytes its data needs (:func:`needed_bytes`) over 3.35 TB/s.

- ``--quick``: the wrapper as the engine launches it
  (``_kernel_cross_attention_i8``), bf16 and fp32 q, graph replay (20
  calls captured, the replays timed with CUDA events) on the same inputs
  (``graph_us``: the 50 MB L2 keeps part of them between calls) and
  cycling through :data:`COPIES` inputs (``cold_graph_us``: as the decode
  step finds each layer's cache), and eager (100 calls back to back), the
  plan where the tree has ``cross_i8_plan``.  It
  builds nothing of its own, so it runs in the tree of a commit before the
  plan too, and one chip call can time parent and change in turns.
- without it, also the source built with parts compiled out
  (:data:`VARIANTS`: ``k_only`` stops after the logits, ``k_softmax``
  after the weights' codes; their outputs are wrong on purpose, only their
  times mean anything) and a ``-DXI8_TRACE`` build whose blocks write
  ``clock64()`` after each phase (and ``%globaltimer`` at their entry and
  end), read per phase as the median and the largest cycles over the
  blocks.  The source is ``csrc/cross_attention_i8.cu``: its trace under
  the wrapper's plan and unclustered, and the whole build under every
  cluster size and thread count :func:`cross_attention_i8.cross_i8_plan`
  can give.  With ``--parent`` it is :data:`PARENT_SRC` alone, the
  one-block-per-row schedule the kernel replaced, which takes no plan (its
  wrapper's times: ``--quick`` in the tree of a commit before the plan).

Needs an NVIDIA card (sm_90a) and ``nvcc``; prints one JSON line, times in
microseconds per call.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import subprocess
import sys

import torch

from . import build
from . import cross_attention_i8 as xi8
from .attention_ablate import _eager_us, _graph_us

MAIN = (16, 20, 1500)  # large-v3's decode step: 16 slots, 20 heads, S 1500
ENGINE_LENS = (400, 800, 1500, 0)  # the 8, 16 and 30 s buckets' lengths, an empty slot
CASES = {"main": None, "engine": ENGINE_LENS}
VARIANTS = {"whole": [], "k_softmax": ["-DXI8_ABLATE_V"], "k_only": ["-DXI8_ABLATE_SOFTMAX"]}
TRACE_SLOTS = 8  # csrc/cross_attention_i8.cu
PARENT_SRC = os.path.join(build.CSRC_DIR, "ablate", "cross_attention_i8_one_block.cu")
COPIES = 4  # inputs a cold timing cycles through: 4 x 65 MB, past the 50 MB L2
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate (as chip_smoke.py)


def make_case(B: int, H: int, S: int, dtype, lens, seed: int = 21):
    """q ``[B, H, 1, 64]`` scaled as the decode step scales it, int8 caches
    (``whisper.quantize_kv``) of positions of unlike magnitude, and the mask
    of per-slot lengths ``lens`` cycled over the slots (None: no mask)."""
    from ..models import whisper as wsp

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn((B, H, 1, 64), generator=g, device="cuda") * 64 ** -0.5).to(dtype)
    k, v = (torch.randn((B, H, S, 64), generator=g, device="cuda")
            * (0.2 + 2.8 * torch.rand((B, H, S, 1), generator=g, device="cuda"))
            for _ in range(2))
    mask = None
    if lens is not None:
        per_slot = torch.tensor([lens[b % len(lens)] for b in range(B)], device="cuda")
        mask = torch.arange(S, device="cuda")[None] < per_slot[:, None]
    return q, wsp.quantize_kv(k), wsp.quantize_kv(v), mask


def needed_bytes(q, mask, codes) -> tuple:
    """The bytes one call must move for this data, and its s8 products' ops:
    the K codes and both scales of valid positions (of every position where
    a row is masked whole: its weights are uniform, so its V scales are
    read), the V codes of rows whose weight's code is not 0, q in and the
    output out.  ``codes`` int8 ``[B, H, S]`` (the plain version's)."""
    B, H, S = codes.shape
    if mask is None:
        valid_k = B * H * S
        valid_vs = valid_k
    else:
        per_slot = mask.sum(1)
        valid_k = int(per_slot.sum().item()) * H
        valid_vs = int(torch.where(per_slot > 0, per_slot, S).sum().item()) * H
    live = int((codes != 0).sum().item())
    small = 2 * B * H * 64 * q.element_size()
    n_bytes = valid_k * (64 + 4) + valid_vs * 4 + live * 64 + small
    return n_bytes, 2.0 * 64 * (valid_k + live), live


def _cycle(fns):
    """A call that runs the next of ``fns`` each time (captured in a graph,
    each launch keeps its own inputs)."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def bound_us(n_bytes: float) -> float:
    return n_bytes / PEAK_BYTES * 1e6


def _plan_brief(plan: dict) -> dict:
    return {k: plan[k] for k in ("cluster", "threads", "blocks", "rows", "smem_bytes")}


def quick(result: dict) -> None:
    has_plan = hasattr(xi8, "cross_i8_plan")
    for dname, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        for cname, lens in CASES.items():
            q, kc, vc, mask = make_case(*MAIN, dtype, lens)
            kern = lambda: xi8._kernel_cross_attention_i8(q, kc, vc, mask)  # noqa: E731
            codes = torch.empty(MAIN, dtype=torch.int8, device="cuda")
            got = xi8._kernel_cross_attention_i8(q, kc, vc, mask, codes=codes)
            want, _, want_codes = xi8._plain_cross_attention_i8(q, kc, vc, mask,
                                                                return_codes=True)
            n_bytes, _, live = needed_bytes(q, mask, want_codes)
            others = [make_case(*MAIN, dtype, lens, seed=22 + i) for i in range(COPIES - 1)]
            cold = _cycle([kern] + [
                (lambda c: lambda: xi8._kernel_cross_attention_i8(*c))(c) for c in others])
            row = {"graph_us": _graph_us(kern), "cold_graph_us": _graph_us(cold),
                   "eager_us": _eager_us(kern),
                   "bound_us": bound_us(n_bytes), "v_rows_live": live,
                   "codes_apart": int((codes != want_codes).sum().item()),
                   "rel_l2": ((got.double() - want.double()).norm()
                              / want.double().norm()).item()}
            if has_plan:
                row["plan"] = _plan_brief(xi8.cross_i8_plan(MAIN[0] * MAIN[1], MAIN[2]))
            result["cases"][f"{cname}_{dname}"] = row


def _lib(path: str, with_plan: bool):
    lib = ctypes.CDLL(path)
    fn = lib.cross_attn_i8
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + ([ctypes.c_void_p] if with_plan else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _raw_call(fn, q, kc, vc, mask, out, plan_arg):
    B, H, S = kc["q"].shape[:3]
    bf16 = int(q.dtype == torch.bfloat16)
    extra = [plan_arg] if plan_arg is not None else []

    def call():
        rc = fn(q.data_ptr(), kc["q"].data_ptr(), kc["s"].data_ptr(), vc["q"].data_ptr(),
                vc["s"].data_ptr(), None if mask is None else mask.data_ptr(),
                out.data_ptr(), None, bf16, B, H, S, *extra,
                torch.cuda.current_stream().cuda_stream)
        build.check(rc, "cross_attn_i8")

    return call


def _plan_arg(plan):
    return None if plan is None else xi8.plan_arg(plan)


def _trace(lib, fn, case, plan, blocks: int) -> dict:
    """One launch of the trace build; per phase the median and the largest
    cycles over the blocks, and the spread of the blocks' entries and ends."""
    q, kc, vc, mask = case
    out = torch.empty_like(q)
    _raw_call(fn, q, kc, vc, mask, out, _plan_arg(plan))()
    torch.cuda.synchronize()
    n = min(blocks, 4096)
    buf = (ctypes.c_longlong * (n * TRACE_SLOTS))()
    lib.cross_attn_i8_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    build.check(lib.cross_attn_i8_trace(ctypes.addressof(buf), n), "cross_attn_i8_trace")
    t = torch.tensor(list(buf), dtype=torch.float64).view(n, TRACE_SLOTS)
    clocks, timer = t[:, :TRACE_SLOTS - 2], t[:, TRACE_SLOTS - 2:]
    phases = {}
    for i in range(clocks.shape[1] - 1):
        d = clocks[:, i + 1] - clocks[:, i]
        d = d[(clocks[:, i + 1] > 0) & (clocks[:, i] > 0)]
        if d.numel():
            phases[f"{i}-{i + 1}"] = {"median_cycles": d.median().item(),
                                      "max_cycles": d.max().item()}
    t0 = timer[:, 0].min()
    return {"phase_cycles": phases, "blocks": n,
            "entry_us_max": ((timer[:, 0] - t0).max() / 1e3).item(),
            "end_us_min": ((timer[:, 1] - t0).min() / 1e3).item(),
            "end_us_max": ((timer[:, 1] - t0).max() / 1e3).item(),
            "block_us_median": ((timer[:, 1] - timer[:, 0]).median() / 1e3).item()}


def ablate(result: dict, parent: bool) -> None:
    src = PARENT_SRC if parent else os.path.join(build.CSRC_DIR, "cross_attention_i8.cu")
    with_plan = not parent
    out_dir = os.path.join(build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    flags = {**VARIANTS, "trace": ["-DXI8_TRACE"]}
    procs = {n: subprocess.Popen(
        build.nvcc_command(src, os.path.join(out_dir, f"libxi8_{n}.so"), f),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n, f in flags.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{log}")
        libs[n] = _lib(os.path.join(out_dir, f"libxi8_{n}.so"), with_plan)
    BH, S = MAIN[0] * MAIN[1], MAIN[2]
    plan = xi8.cross_i8_plan(BH, S) if with_plan else None
    result["source"] = os.path.relpath(src, os.path.dirname(build.PKG_DIR))
    result["variants_graph_us"], result["trace"] = {}, {}
    for cname, lens in CASES.items():
        case = make_case(*MAIN, torch.bfloat16, lens)
        out = torch.empty_like(case[0])
        result["variants_graph_us"][cname] = {
            n: _graph_us(_raw_call(fn, *case, out, _plan_arg(plan)))
            for n, (_, fn) in libs.items() if n != "trace"}
        traced = [plan]
        if plan is not None and plan["cluster"] > 1:  # and the same blocks unclustered
            traced.append(xi8.cross_i8_plan(BH, S, cluster=1, threads=plan["threads"]))
        for tp in traced:
            key = cname if tp is plan else f"{cname}_cluster_1"
            result["trace"][key] = _trace(*libs["trace"], case, tp,
                                          BH * (tp["cluster"] if tp else 1))
    if not with_plan:
        return
    _, whole = libs["whole"]
    result["plans_graph_us"] = {}
    for cname, lens in CASES.items():
        q, kc, vc, mask = make_case(*MAIN, torch.bfloat16, lens)
        out = torch.empty_like(q)
        want = xi8._plain_cross_attention_i8(q, kc, vc, mask)
        rows = {}
        for cluster in xi8.CLUSTERS:
            for threads in xi8.THREADS:
                try:
                    p = xi8.cross_i8_plan(BH, S, cluster=cluster, threads=threads)
                except ValueError:
                    continue
                call = _raw_call(whole, q, kc, vc, mask, out, _plan_arg(p))
                call()
                err = ((out.double() - want.double()).norm() / want.double().norm()).item()
                rows[f"C {cluster} T {threads}"] = {"blocks": p["blocks"],
                                                    "graph_us": _graph_us(call),
                                                    "rel_l2": err}
        result["plans_graph_us"][cname] = rows


def main() -> int:
    if not torch.cuda.is_available():
        print("cross_attention_i8_ablate: no CUDA device", file=sys.stderr)
        return 1
    from ..utils.platform import card_info

    args = sys.argv[1:]
    result = {"device": torch.cuda.get_device_name(0), "card": card_info(),
              "shape": [*MAIN, 64], "engine_lens": ENGINE_LENS, "cases": {}}
    if "--parent" not in args:
        quick(result)
    if "--quick" not in args:
        ablate(result, "--parent" in args)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
