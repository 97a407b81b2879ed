"""Kernel 3's launch plan (``ops/cross_attention_i8.py`` ``cross_i8_plan``)
and its cluster schedule, on the CPU.

The kernel (``csrc/cross_attention_i8.cu``) runs only on the card, where
``tests/test_torch_kernels.py`` and ``chip_smoke.py`` hold it to the plain
version.  Here:

- the plan owns every position of every (b, h) row exactly once (block r
  of a cluster of C takes ``[r R, (r + 1) R)``, R = ceil(S / C), empty
  where S < C); cluster sizes 1-8, the threads the kernel is built for;
  its shared memory (a K slot of one row a thread, then four arrays of R
  words) within 232,448 bytes a block with the kernel's static arrays;
  every S up to ``MAX_S`` plannable at any number of rows (where a
  block's positions do not fit, fewer threads, then a larger cluster); at
  whisper-large-v3's decode step ``(320, 1500)`` at least one block on
  every one of the 132 SMs, also counting only the blocks that hold a
  valid position at the STT engine's masks (lengths 400, 800, 1500 and 0
  cycled over the 16 slots);
- the wrapper refuses a shape the plan cannot hold before the device;
- a numpy emulation of the schedule the kernel runs (per block the max of
  its span's logits, merged over the cluster; per block the sum of exps,
  merged in rank order; per block the max of ``wp``, merged; then each
  block's codes against the one ``ws`` and its int32 partial P.V, summed)
  against the core of the JAX package's ``cross_attention_step_i8`` (its
  projections set to the identity) and against
  ``_plain_cross_attention_i8``, 3 slots of 4 heads of 64 from a numpy
  seed: unmasked, prefix masks, a mask with holes, a row masked whole
  (uniform weights), a block whose whole range is masked, S smaller than
  C.  Tolerances as ``tests/test_torch_cross_i8.py`` states for fp32: the
  outputs within 1e-5; the weights' codes one apart at most, on at most one
  in a thousand of them (at least one allowed): the cluster sums the exps
  in another order, which moves a code at a tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infernos_tpu.models import layers as JL
from infernos_tpu_torch.models import whisper as wsp
from infernos_tpu_torch.ops import cross_attention_i8 as xi8

B, H, DH = 3, 4, 64
NEG_INF = np.float32(-1e9)
SMEM_MAX = 232448
ENGINE = (16, 20, 1500)
ENGINE_LENS = (400, 800, 1500, 0)
SHAPES = [(320, 1500), (1, 1500), (12, 37), (12, 3), (1, 1), (320, 63), (20, 1500),
          (80, 1500), (7, 4097), (1, xi8.MAX_S), (528, 14000), (320, 30000),
          (600, 45670), (600, xi8.MAX_S)]


def _ranges(plan):
    S, C = plan["S"], plan["cluster"]
    return [xi8.block_range(S, C, r) for r in range(C)]


@pytest.mark.parametrize("BH,S", SHAPES)
def test_plan_owns_every_position_once(BH, S):
    plan = xi8.cross_i8_plan(BH, S)
    seen = np.zeros(S, dtype=np.int64)
    for s0, s1 in _ranges(plan):
        assert 0 <= s0 <= s1 <= S and s1 - s0 <= plan["rows"]
        seen[s0:s1] += 1
    assert (seen == 1).all()
    assert plan["blocks"] == BH * plan["cluster"]


@pytest.mark.parametrize("BH,S", SHAPES)
def test_plan_shared_memory_and_sizes(BH, S):
    plan = xi8.cross_i8_plan(BH, S)
    C, T, R = plan["cluster"], plan["threads"], plan["rows"]
    assert C in (1, 2, 4, 8) and (C == 1 or C <= S)
    assert T in (64, 128, 256)
    assert R == -(-S // C)
    assert plan["smem_bytes"] == T * 64 + 4 * 4 * (-(-R // 4) * 4)
    assert plan["smem_bytes"] + xi8.STATIC_SMEM <= SMEM_MAX
    assert plan["smem_bytes"] % 16 == 0
    assert xi8.cross_i8_plan_ints(plan) == [C, T, R, plan["smem_bytes"]]
    assert list(xi8.plan_arg(plan)) == xi8.cross_i8_plan_ints(plan)


def test_plan_fills_every_sm_at_the_engine_shape():
    """Large-v3's decode step: at least one block an SM, also of the blocks
    that hold a valid position at the engine's masks; every block of the
    grid resident at once (the kernel's 1,280 threads an SM)."""
    Bs, Hs, S = ENGINE
    plan = xi8.cross_i8_plan(Bs * Hs, S)
    assert plan["blocks"] >= xi8.SMS
    lens = [ENGINE_LENS[b % len(ENGINE_LENS)] for b in range(Bs)]
    busy = sum(Hs for n in lens for s0, s1 in _ranges(plan) if s0 < min(s1, n))
    assert busy >= xi8.SMS
    assert plan["blocks_per_sm"] * xi8.SMS >= plan["blocks"]
    assert plan["blocks_per_sm"] * plan["threads"] <= xi8.RESIDENT_THREADS


@pytest.mark.parametrize("BH", [1, 320, 528, 600])
def test_every_s_up_to_max_s_is_plannable(BH):
    """Every S in 1..MAX_S has a plan at these row counts (the one-block
    schedule the kernel replaced took S up to 45,670 at any count): where
    the resident plan's shared memory does not hold a block's positions,
    the plan takes fewer threads, then a larger cluster, and never a
    smaller one than the block count asks for."""
    plan = xi8.cross_i8_plan.__wrapped__
    want_c = next((c for c in xi8.CLUSTERS if BH * c >= xi8.TARGET_BLOCKS), 8)
    for S in range(1, xi8.MAX_S + 1):
        p = plan(BH, S)
        assert p["smem_bytes"] + xi8.STATIC_SMEM <= SMEM_MAX
        assert p["cluster"] >= min(want_c, max(c for c in xi8.CLUSTERS if c <= S))
    assert plan(BH, 1500) == xi8.cross_i8_plan(BH, 1500)


def test_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="no plan"):
        xi8.cross_i8_plan(0, 10)
    with pytest.raises(ValueError, match="no plan"):
        xi8.cross_i8_plan(4, xi8.MAX_S + 1)
    with pytest.raises(ValueError, match="no plan"):
        xi8.cross_i8_plan(4, 100, cluster=3)
    with pytest.raises(ValueError, match="no plan"):
        xi8.cross_i8_plan(4, 100, threads=96)
    with pytest.raises(ValueError, match="shared memory"):
        xi8.cross_i8_plan(1, xi8.MAX_S, cluster=4)
    with pytest.raises(ValueError, match="grid"):
        xi8.cross_i8_plan(2 ** 30, 2, cluster=2)


def test_wrapper_refuses_an_unplannable_shape_before_the_device():
    """An S past MAX_S passes every check of the inputs and is refused by
    the plan, before the device check; a plannable one reaches it."""
    S = xi8.MAX_S + 1
    q = torch.zeros((1, 1, 1, DH))
    cache = {"q": torch.zeros((1, 1, 1, DH), dtype=torch.int8).expand(1, 1, S, DH)
             .contiguous(), "s": torch.ones((1, 1, S, 1))}
    before = xi8.cross_attention_i8.launches
    with pytest.raises(ValueError, match="no plan"):
        xi8._kernel_cross_attention_i8(q, cache, cache)
    small = {"q": cache["q"][:, :, :10].contiguous(), "s": cache["s"][:, :, :10].contiguous()}
    with pytest.raises(ValueError, match="CUDA"):
        xi8._kernel_cross_attention_i8(q, small, small)
    assert xi8.cross_attention_i8.launches == before


# -- the cluster schedule, emulated -------------------------------------------------

def _emulate(q, kq, ks, vq, vs, mask, C):
    """The kernel's schedule in numpy fp32 for q ``[B, H, 64]``, codes
    ``[B, H, S, 64]``, scales ``[B, H, S]``, mask ``[B, S]`` or None, in
    clusters of C: returns the output ``[B, H, 64]`` and the weights' codes."""
    Bq, Hq, S = kq.shape[:3]
    out = np.zeros((Bq, Hq, DH), np.float32)
    codes = np.zeros((Bq, Hq, S), np.int8)
    f32 = np.float32
    for b in range(Bq):
        valid = np.ones(S, bool) if mask is None else mask[b]
        for h in range(Hq):
            qa = max(np.abs(q[b, h]).max(), f32(1e-8))
            qs = f32(qa) / f32(127.0)
            qq = np.clip(np.rint(q[b, h] / qs), -127, 127).astype(np.int32)
            blocks = []
            for r in range(C):
                s0, s1 = xi8.block_range(S, C, r)
                idx = np.flatnonzero(valid[s0:s1]) + s0
                v0, v1 = (idx[0], idx[-1] + 1) if idx.size else (s0, s0)
                acc = kq[b, h, v0:v1].astype(np.int32) @ qq
                logit = np.where(valid[v0:v1], (acc.astype(f32) * qs) * ks[b, h, v0:v1],
                                 NEG_INF).astype(f32)
                m = logit.max() if logit.size else f32(-np.inf)
                if v0 > s0 or v1 < s1:
                    m = max(m, NEG_INF)
                blocks.append({"s0": s0, "s1": s1, "v0": v0, "v1": v1, "logit": logit, "m": m})
            M = f32(max(blk["m"] for blk in blocks))
            all_range = np.exp(f32(NEG_INF - M)) != 0
            for blk in blocks:
                w0, w1 = (blk["s0"], blk["s1"]) if all_range else (blk["v0"], blk["v1"])
                x = np.full(w1 - w0, NEG_INF, f32)
                x[blk["v0"] - w0:blk["v1"] - w0] = blk["logit"]
                blk["w0"], blk["e"] = w0, np.exp(x - M).astype(f32)
                blk["l"] = blk["e"].sum(dtype=f32)
            L = f32(0)
            for blk in blocks:  # rank order
                L = f32(L + blk["l"])
            for blk in blocks:
                w = blk["e"] / L
                n = w.size
                vsv = vs[b, h, blk["w0"]:blk["w0"] + n]
                blk["wp"] = np.where(w != 0, w * vsv, f32(0)).astype(f32)
            W = max((blk["wp"].max() for blk in blocks if blk["wp"].size), default=f32(0))
            ws = max(f32(W), f32(1e-20)) / f32(127.0)
            total = np.zeros(DH, np.int64)
            for blk in blocks:
                c = np.clip(np.rint(blk["wp"] / ws), 0, 127).astype(np.int32)
                w0 = blk["w0"]
                codes[b, h, w0:w0 + c.size] = c
                live = np.flatnonzero(c) + w0
                total += (c[c != 0][:, None] * vq[b, h, live].astype(np.int32)).sum(0)
            assert np.abs(total).max(initial=0) < 2 ** 31
            out[b, h] = total.astype(f32) * ws
    return out, codes


def _inputs(S, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, 1, DH)) * DH ** -0.5).astype(np.float32)
    k, v = (torch.from_numpy((rng.standard_normal((B, H, S, DH))
                              * rng.uniform(0.2, 3.0, (B, H, S, 1))).astype(np.float32))
            for _ in range(2))
    return q, wsp.quantize_kv(k), wsp.quantize_kv(v)


def _reference(q, kc, vc, mask):
    """The JAX package's ``cross_attention_step_i8`` with identity
    projections on ``x_q = 8 q`` (it scales q by 64 ** -0.5 itself): its
    core, time-minor caches, ``[B, H, 64]`` and its weights' codes."""
    D = H * DH
    eye = {"w": jnp.eye(D, dtype=jnp.float32), "b": jnp.zeros(D, jnp.float32)}
    x = jnp.asarray(q.transpose(0, 2, 1, 3).reshape(B, 1, D) * np.float32(8.0))
    tm = [{"q": jnp.asarray(c["q"].numpy().swapaxes(-1, -2)),
           "s": jnp.asarray(c["s"].numpy().swapaxes(-1, -2))} for c in (kc, vc)]
    jmask = None if mask is None else jnp.asarray(mask)
    out = JL.cross_attention_step_i8({"q": eye, "o": eye}, x, *tm, n_heads=H, kv_mask=jmask)
    return np.asarray(out).reshape(B, H, DH)


def _mask(kind, S):
    rng = np.random.default_rng(S)
    if kind == "none":
        return None
    if kind == "prefix":
        lens = [S, S // 2 + 1, 1]
    elif kind == "row_masked_whole":
        lens = [S, 0, S // 3 + 1]
    elif kind == "range_masked_whole":  # the last blocks of a cluster of 4 hold nothing valid
        lens = [1, S // 4, S // 2]
    else:  # "holes": a mask that is not a prefix
        m = rng.random((B, S)) < 0.6
        m[:, 0] = True
        return m
    return np.arange(S)[None] < np.asarray(lens)[:, None]


CASES = [(S, kind, C) for S in (37, 64) for kind in
         ("none", "prefix", "holes", "row_masked_whole", "range_masked_whole")
         for C in (1, 2, 4, 8)] + [(3, kind, 8) for kind in ("none", "prefix", "row_masked_whole")]


@pytest.mark.parametrize("S,kind,C", CASES)
def test_cluster_schedule_matches_reference(S, kind, C):
    q, kc, vc = _inputs(S, seed=S + C)
    mask = _mask(kind, S)
    plan = xi8.cross_i8_plan(B * H, S, cluster=C)
    assert plan["cluster"] == C
    got, codes = _emulate(q[:, :, 0], kc["q"].numpy(), kc["s"].numpy()[..., 0],
                          vc["q"].numpy(), vc["s"].numpy()[..., 0], mask, C)
    want = _reference(q, kc, vc, mask)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tq = torch.from_numpy(q)
    tmask = None if mask is None else torch.from_numpy(mask)
    plain, _, plain_codes = xi8._plain_cross_attention_i8(tq, kc, vc, tmask, return_codes=True)
    np.testing.assert_allclose(got, plain[:, :, 0].numpy(), rtol=1e-5, atol=1e-5)
    diff = np.abs(codes.astype(np.int32) - plain_codes.numpy().astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= max(1, codes.size // 1000)
    assert np.isfinite(got).all()
    if kind == "row_masked_whole":  # uniform weights over every position
        wp = np.float32(1.0) / np.float32(S) * vc["s"][1, :, :, 0].numpy()
        ws = wp.max(axis=-1, keepdims=True) / np.float32(127.0)
        np.testing.assert_array_equal(codes[1], np.clip(np.rint(wp / ws), 0, 127))
    if kind == "range_masked_whole" and C == 4:
        assert any(not mask[0, s0:s1].any() for s0, s1 in _ranges(plan) if s1 > s0)
    if S < C:
        assert any(s0 == s1 for s0, s1 in _ranges(plan))
