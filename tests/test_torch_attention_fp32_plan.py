"""The fp32 attention kernel's launch plan (``ops/attention.py`` ``fp32_plan``)
and its key-split schedule, on the CPU.

The kernel (``csrc/attention_fp32.cu``) runs only on the card, where
``tests/test_torch_kernels.py`` and ``chip_smoke.py`` hold it to the plain
version.  Here:

- the plan owns every (row, key tile) of every head exactly once, gives no
  block an empty key range, and each row of a q tile to one block of its
  cluster for the merge; its shared memory fits 232,448 bytes, regions
  16-byte aligned and apart; at the main path's shapes (the tiny-real
  encodes ``[4|8, 100|250]``, the tiny STT trainer's ``[32, 250]``) it
  takes the plan measured best on an H100, about one block an SM (at least
  120 blocks where a cluster of at most 2 reaches it, else the most any
  plan gives), and at ``[20, 1500]`` the 480 of one block per 64 rows;
- the wrapper refuses a shape the plan cannot hold before the device;
- a plain PyTorch emulation of the schedule the kernel runs (each block's
  partial ``(m, l, O)`` in base 2 over its key tiles, then ``O = sum_i
  2^(m_i - M) O_i / sum_i 2^(m_i - M) l_i``) against JAX
  ``_pallas_attention(..., interpret=True)`` at the tiny-real encoder's
  width (4 heads of 64, S 250, a key mask per utterance), within fp32
  round-off (1e-5), under the wrapper's plan and others; and with a key
  range entirely past S, which must weigh nothing (finite, the same).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from infernos_tpu.ops.attention import NEG_INF as JNEG_INF
from infernos_tpu.ops.attention import _pallas_attention
from infernos_tpu_torch.ops import attention as attn

FP32 = dict(atol=1e-5, rtol=1e-5)
SMEM_MAX = 232448
MAIN_SHAPES = [(4, 100), (4, 250), (8, 250), (32, 250)]
SHAPES = MAIN_SHAPES + [(20, 1500), (1, 1), (4, 63), (4, 65), (4, 129), (1, 600),
                        (6, 1500), (3, 37), (2, 4096)]
LOG2E = float(np.log2(np.e))


def _blocks(plan):
    """Each block's (head, first row, rows past the first, key tiles [t0, t1),
    cluster rank), in launch order, as the kernel derives them from
    blockIdx.x."""
    S, rows, split = plan["S"], plan["rows"], plan["split"]
    for block in range(plan["blocks"]):
        pair, rank = divmod(block, split)
        bh, qt = divmod(pair, plan["n_qt"])
        q0 = qt * rows
        yield bh, q0, min(S, q0 + rows), *attn.fp32_key_range(plan["n_kt"], split, rank), rank


@pytest.mark.parametrize("BH,S", SHAPES)
def test_plan_owns_every_row_and_key_tile_once(BH, S):
    plan = attn.fp32_plan(BH, S)
    split, rows = plan["split"], plan["rows"]
    seen = np.zeros((BH, S, plan["n_kt"]), dtype=np.int64)
    merged = np.zeros((BH, S), dtype=np.int64)
    R = rows // split
    assert R * split == rows and plan["blocks"] == BH * plan["n_qt"] * split
    for bh, r0, r1, t0, t1, rank in _blocks(plan):
        assert 0 <= t0 < t1 <= plan["n_kt"] and r0 < r1, "an empty block"
        seen[bh, r0:r1, t0:t1] += 1
        merged[bh, r0 + rank * R:min(r1, r0 + (rank + 1) * R)] += 1
    assert (seen == 1).all()
    assert (merged == 1).all()


@pytest.mark.parametrize("BH,S", SHAPES)
def test_plan_shared_memory_fits_without_overlap(BH, S):
    plan = attn.fp32_plan(BH, S)
    rows, stages, split = plan["rows"], plan["stages"], plan["split"]
    want = {"q": rows * 68 * 4, "p": rows * (64 + plan["x"]) * 4,
            "stage": stages * (64 * 68 + 64 * 64 + 64) * 4,
            "recv": rows * 68 * 4 if split > 1 else 0}
    assert plan["sizes"] == want
    assert stages == (2 if -(-plan["n_kt"] // split) > 1 else 1)
    spans = sorted((plan["offsets"][k], plan["offsets"][k] + n) for k, n in want.items() if n)
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    assert all(a % 16 == 0 for a, _ in spans)
    assert spans[-1][1] == plan["smem_bytes"] <= SMEM_MAX
    assert attn.fp32_plan_ints(plan) == [rows, plan["x"], split, stages,
                                         plan["offsets"]["p"], plan["offsets"]["stage"],
                                         plan["offsets"]["recv"], plan["smem_bytes"]]


# the plan at the main path's shapes, as measured best on an H100
# (ops/attention_ablate.py --fp32 times every other plan there)
PLANS = {(4, 100): (16, 16, 2, 56), (4, 250): (16, 16, 2, 128), (8, 250): (32, 16, 2, 128),
         (32, 250): (64, 8, 1, 128), (20, 1500): (64, 8, 1, 480)}


@pytest.mark.parametrize("BH,S", sorted(PLANS))
def test_plan_fills_the_card_at_the_main_path_shapes(BH, S):
    """About one block an SM: at least FP32_TARGET_BLOCKS (120 of 132 SMs)
    where a plan of split 1 or 2 reaches it, else the most blocks any plan
    gives; and never fewer than one block per 64 rows of every head (the
    parallelism of the kernel it replaced)."""
    plan = attn.fp32_plan(BH, S)
    assert tuple(plan[k] for k in ("rows", "x", "split", "blocks")) == PLANS[BH, S]
    n_kt = -(-S // 64)
    most = max(BH * -(-S // r) * c for r, _, c in attn._fp32_candidates(n_kt))
    assert plan["blocks"] >= attn.FP32_TARGET_BLOCKS or plan["blocks"] == most
    assert plan["blocks"] >= BH * -(-S // 64)


def test_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="no plan"):
        attn.fp32_plan(0, 10)
    with pytest.raises(ValueError, match="no plan"):
        attn.fp32_plan(4, 100, rows=16, x=16, split=4)  # 2 key tiles for 4 blocks
    with pytest.raises(ValueError, match="no plan"):
        attn.fp32_plan(4, 100, rows=48, x=8, split=1)
    with pytest.raises(ValueError, match="no plan"):
        attn.fp32_plan(4, 100, rows=16, x=8, split=1)
    with pytest.raises(ValueError, match="grid"):
        attn.fp32_plan(2 ** 31, 1)


def test_wrapper_refuses_an_unplannable_shape_before_the_device():
    """2^31 heads of one row (a stride-0 view: nothing allocated) pass every
    check of the inputs; the plan refuses them before the device check."""
    q = torch.zeros((1, 1, 64)).expand(2 ** 31, 1, 64)
    before = (attn.fused_attention.launches, attn.fused_attention.launches_fp32)
    with pytest.raises(ValueError, match="more than a grid holds"):
        attn._kernel_attention(q, q, q, None)
    with pytest.raises(ValueError, match="no plan"):
        attn._kernel_attention(*(torch.zeros((2, 0, 64)) for _ in range(3)), None)
    with pytest.raises(ValueError, match="CUDA"):  # a plannable shape reaches the device check
        attn._kernel_attention(*(torch.zeros((2, 10, 64)) for _ in range(3)), None)
    assert (attn.fused_attention.launches, attn.fused_attention.launches_fp32) == before


# -- the split schedule, emulated ---------------------------------------------------

def _partial(qt, kt, vt, madd, scale):
    """One block's partial over its keys, in base 2: (m, l, O) per row; a
    row with no real key (m = -inf) holds l = 0, O = 0."""
    s = torch.einsum("bqd,bkd->bqk", qt, kt) * (scale * LOG2E) + madd[:, None, :] * LOG2E
    m = s.amax(-1)
    p = torch.where(torch.isfinite(m)[..., None], torch.exp2(s - m[..., None]),
                    torch.zeros_like(s))
    return m, p.sum(-1), torch.einsum("bqk,bkd->bqd", p, vt)


def _merge(parts):
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        w = torch.where(torch.isfinite(m), torch.exp2(m - M), torch.zeros_like(m))
        L = L + w * l
        O = O + w[..., None] * o
    return O / L[..., None]


def emulate(q, k, v, mask_add, rows, ranges):
    """``[BH, S, 64]`` fp32 through the kernel's schedule: q tiles of
    ``rows``, each merged from one partial a key range of ``ranges`` (key
    tiles ``[t0, t1)``, 64 keys a tile; keys >= S are -inf padding)."""
    BH, S, Dh = q.shape
    n_kt = max(t1 for _, t1 in ranges)
    pad = n_kt * 64 - S
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    mp = torch.nn.functional.pad(mask_add, (0, pad), value=float("-inf"))
    out = torch.empty_like(q)
    for q0 in range(0, S, rows):
        qt = q[:, q0:q0 + rows]
        parts = [_partial(qt, kp[:, 64 * t0:64 * t1], vp[:, 64 * t0:64 * t1],
                          mp[:, 64 * t0:64 * t1], Dh ** -0.5) for t0, t1 in ranges]
        out[:, q0:q0 + rows] = _merge(parts)
    return out


B, S, H, Dh = 2, 250, 4, 64


@pytest.fixture(scope="module")
def tiny_real():
    """Two utterances of the 5 s bucket, 4 heads of 64, a key mask per
    utterance (the second 131 keys long): the port's ``[BH, S, 64]`` inputs
    and JAX's kernel output on them (padded to 256 with masked keys)."""
    rng = np.random.default_rng(19)
    q, k, v = (rng.standard_normal((B, S, H * Dh)).astype(np.float32) for _ in range(3))
    mask = np.arange(S)[None] < np.array([[S], [131]])
    madd = np.where(mask, 0.0, JNEG_INF).astype(np.float32).repeat(H, axis=0)

    def split(a):  # [B, S, H * Dh] -> [B * H, S, Dh]
        return a.reshape(B, S, H, Dh).transpose(0, 2, 1, 3).reshape(B * H, S, Dh)

    qs, ks, vs = (split(a) for a in (q, k, v))
    jpad = [jnp.pad(jnp.asarray(a), ((0, 0), (0, 256 - S), (0, 0))) for a in (qs, ks, vs)]
    jmask = jnp.pad(jnp.asarray(madd), ((0, 0), (0, 256 - S)), constant_values=JNEG_INF)
    want = np.asarray(_pallas_attention(*jpad, jmask, block_q=128, interpret=True))[:, :S]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (qs, ks, vs)] + [
        torch.from_numpy(madd), want]


@pytest.mark.parametrize("rows,x,split", [(None, None, None), (16, 16, 4), (64, 8, 2),
                                         (32, 16, 4), (64, 8, 1)])
def test_split_schedule_matches_jax_pallas_at_tiny_real_width(tiny_real, rows, x, split):
    q, k, v, madd, want = tiny_real
    plan = attn.fp32_plan(B * H, S, rows=rows, x=x, split=split)
    ranges = [attn.fp32_key_range(plan["n_kt"], plan["split"], r) for r in range(plan["split"])]
    got = emulate(q, k, v, madd, plan["rows"], ranges)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_split_schedule_with_a_key_range_past_s_weighs_it_nothing(tiny_real):
    """Five ranges over S 250's four key tiles, the last one (keys 256-319)
    entirely past S: its partial has m = -inf, and the merge leaves it out
    instead of taking 2^(-inf - (-inf)) = NaN."""
    q, k, v, madd, want = tiny_real
    ranges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]
    got = emulate(q, k, v, madd, 16, ranges)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    m, l, o = _partial(q[:, :16], torch.zeros((B * H, 64, Dh)), torch.zeros((B * H, 64, Dh)),
                       torch.full((B * H, 64), float("-inf")), Dh ** -0.5)
    assert torch.isneginf(m).all() and (l == 0).all() and (o == 0).all()
