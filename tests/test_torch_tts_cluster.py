"""The cluster kernel's launch plan (kernel 2 over fp32 caches), on the CPU.

``csrc/tts_step_cluster.cu`` runs the decoder step over fp32 caches as
thread-block clusters that keep the hidden state in shared memory; the
kernel runs only on the card (``tests/test_torch_kernels.py``, marked
``cuda``, holds it to the plain step there).  Its plan is Python
(``ops/tts_step.py`` ``cluster_plan``) and is checked here, at the dry
run's kernel width (D 256, F 512), at the tiny-real TTS engine's (D 256,
F 768) and at SpeechT5's full width (D 768, F 3072), for 1 to 48 slots:

- every output column of every product is owned by exactly one block of
  a cluster, and a block's chunks of K tiles cover its K rows once, each
  chunk within a ring slot;
- every (slot, head) attention item is run exactly once, by a block that
  has room for it, and the cluster's slot groups cover the slots once;
- the shared-memory regions do not overlap, are 128-byte aligned and fit
  a block's 232,448 bytes; a cluster is at most 16 blocks;
- a shape beyond the plan's limit raises ValueError before any launch
  (through the wrapper, before the device check);
- ``launches_per_step`` agrees, in every mode, with what the wrapper
  counts in ``ops.launch_counts()`` (the launch functions recorded, not
  run).
"""

import math
from types import SimpleNamespace

import pytest
import torch

from infernos_tpu_torch import ops
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.ops import tts_step as ts

# (D, F, layers)
WIDTHS = {"dry_run": (256, 512, 2), "tiny_real": (256, 768, 3), "full": (768, 3072, 6)}
SLOTS = (1, 2, 3, 5, 7, 8, 9, 12, 16, 17, 24, 31, 32, 33, 40, 47, 48)


def _plans():
    for name, (D, F, L) in WIDTHS.items():
        for B in SLOTS:
            for int8w in (False, True):
                yield name, B, D, F, L, int8w


@pytest.mark.parametrize("name,B,D,F,L,int8w", list(_plans()))
def test_plan_owns_every_column_item_and_k_row_once(name, B, D, F, L, int8w):
    plan = ts.cluster_plan(B, D, F, L, int8w)
    assert 1 <= plan["csize"] <= 16 and plan["rows"] <= ts.CLUSTER_ROWS
    assert plan["clusters"] == math.ceil(B / plan["rows"])
    assert (plan["clusters"] - 1) * plan["rows"] < B <= plan["clusters"] * plan["rows"]
    esz = 1 if int8w else 2
    for g, (K, N) in enumerate(ts.gemm_shapes(D, F)):
        gm = plan["gemms"][g]
        owned = []
        for rank, (p0, n) in enumerate(gm["shares"]):
            owned += range(p0 * 16, (p0 + n) * 16)
            assert n <= ts.CLUSTER_MAX_NP
            assert n * ts.k_splits(n) <= ts.CLUSTER_MAX_PAIRS
            rows = []
            for k0, kc in ts.cluster_chunks(plan, g, rank):
                rows += range(k0 * 16, (k0 + kc) * 16)
                assert n * kc * 256 * esz <= plan["slot_bytes"]
            assert rows == (list(range(K)) if n else [])
        assert owned == list(range(N)), f"product {g}: columns owned {len(owned)} of {N}"
    slots = set()
    for c in range(plan["clusters"]):
        items = ts.cluster_items(plan, c)
        pairs = {(b, h) for b, h, *_ in items}
        assert len(pairs) == len(items)
        for b, h, rank, k, team, rnd in items:
            assert 0 <= rank < plan["csize"] and k < plan["ipb"] and team < plan["teams"]
        slots |= {b for b, _ in pairs}
        R = min(plan["rows"], B - c * plan["rows"])
        assert pairs == {(c * plan["rows"] + n, h) for n in range(R)
                         for h in range(D // 64)}
    assert slots == set(range(B))


@pytest.mark.parametrize("name,B,D,F,L,int8w", list(_plans()))
def test_plan_shared_memory_fits_and_does_not_overlap(name, B, D, F, L, int8w):
    plan = ts.cluster_plan(B, D, F, L, int8w)
    assert 2 <= plan["nslot"] <= ts.CLUSTER_MAX_SLOTS
    assert plan["smem_bytes"] <= 232448
    regions = [(0, plan["nslot"] * plan["slot_bytes"])] + [
        (plan["offsets"][k], plan["offsets"][k] + plan["sizes"][k]) for k in plan["offsets"]]
    regions.sort()
    for (a0, a1), (b0, _) in zip(regions, regions[1:]):
        assert a1 <= b0
    assert regions[-1][1] <= plan["smem_bytes"]
    assert all(off % 128 == 0 for off in plan["offsets"].values())
    assert plan["slot_bytes"] % 128 == 0
    H = D // 64
    assert plan["ipb"] * plan["csize"] >= plan["rows"] * H
    assert plan["teams"] in (1, 2, 4, 8) and plan["teams"] >= min(plan["ipb"], 8)
    assert plan["sizes"]["xs1"] == 8 * (max(D, F) + 8) * 2
    ints = ts.cluster_plan_ints(plan)
    assert len(ints) == 20 and ints[-1] == plan["smem_bytes"]
    colsum = sum(-(-N // 16 // plan["csize"]) * 16 for _, N in ts.gemm_shapes(D, F))
    assert plan["sizes"]["bias"] == L * colsum * 4 * (2 if int8w else 1)


def test_tiny_real_plan_holds_a_layer_of_weights_and_spreads_the_items():
    """At the tiny-real shape two clusters of 16 blocks own 4 of the 8
    slots each, each block takes one of its cluster's 16 (slot, head)
    items with all 8 warps, every product is one chunk, and the ring holds
    a layer's six chunks."""
    plan = ts.cluster_plan(8, 256, 768, 3, False)
    assert (plan["clusters"], plan["rows"], plan["csize"], plan["teams"], plan["ipb"]) == \
        (2, 4, 16, 1, 1)
    assert all(len(ts.cluster_chunks(plan, g, r)) == 1 for g in range(6) for r in range(16))
    assert plan["nslot"] >= 6


@pytest.mark.parametrize("D,F,what", [(256, 4352, "N <= 4096"), (768, 8192, "N <= 4096"),
                                      (1408, 1024, "N <= 4096")])
def test_plan_refuses_a_shape_beyond_its_limit(D, F, what):
    with pytest.raises(ValueError, match=what):
        ts.cluster_plan(8, D, F, 1, False)


def _panel_args(D, F, B, cdt, H=None, T=8, S=4, int8w=False):
    """Weights packed in the card's panel layout, on the CPU (one layer)."""
    cfg = st5.SpeechT5Config(hidden_size=D, decoder_layers=1,
                             decoder_attention_heads=D // 64, encoder_attention_heads=D // 64,
                             decoder_ffn_dim=F)
    fw = {}
    for n, (K, N) in zip(ts._GEMMS, ts.gemm_shapes(D, F)):
        fw[n] = torch.zeros((1, N // 16, K // 16, 256),
                            dtype=torch.int8 if int8w else torch.bfloat16)
    for n, (K, N) in zip(ts._BIASES, ts.gemm_shapes(D, F)):
        fw[n] = torch.zeros((1, N))
    if int8w:
        for n, (K, N) in zip(ts._SCALES, ts.gemm_shapes(D, F)):
            fw[n] = torch.ones((1, N))
    for n in ts._LNS:
        fw[n] = torch.zeros((1, D))
    cache = st5.init_cache(cfg, B, T, S, "cpu", dtype=cdt)
    return cfg, fw, cache, torch.zeros((B, 1, D)), torch.zeros(B, dtype=torch.long)


def test_wrapper_refuses_a_shape_beyond_the_limit_before_the_device():
    """F 4352 over fp32 caches: the cluster plan's ValueError, raised before
    the device check (the CPU tensors would fail that one); over bf16 caches
    the grid kernel's plan takes the shape as far as the device."""
    cfg, fw, cache, x, pos = _panel_args(256, 4352, 2, torch.float32)
    with pytest.raises(ValueError, match="at most 16"):
        ts._kernel_decode_step(fw, cfg, x, cache, pos)
    cfg, fw, cache, x, pos = _panel_args(256, 4352, 2, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ts._kernel_decode_step(fw, cfg, x, cache, pos)


@pytest.mark.parametrize("int8w", [False, True])
@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 8, 32, 33, 40, 48, 65])
def test_launches_per_step_is_what_the_wrapper_counts(monkeypatch, int8w, cdt, B):
    """The wrapper with its launches recorded instead of run: each mode's
    counter moves by ``launches_per_step(B, fp32_caches)``, no other
    counter moves, and each launch got the slots the mode gives it."""
    cfg, fw, cache, x, pos = _panel_args(128, 256, B, cdt, int8w=int8w)
    seen = []
    monkeypatch.setattr(ts, "_check_device", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(ts, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(ts.build, "load", lambda name: SimpleNamespace(
        **{e: name for e, _ in ts._MODES.values()}))
    monkeypatch.setattr(ts, "_launch", lambda fn, fw, cfg, x, *a, **k: seen.append(
        (fn, x.shape[0])))
    monkeypatch.setattr(ts, "_launch_cluster", lambda fn, fw, cfg, x, *a: seen.append(
        (fn, x.shape[0])) or torch.empty_like(x))
    before = ops.launch_counts()
    ts._kernel_decode_step(fw, cfg, x, cache, pos)
    moved = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
    fp32 = cdt == torch.float32
    key = {(False, False): "bf16_step", (True, False): "int8_step",
           (False, True): "fp32_step", (True, True): "int8_fp32_step"}[(int8w, fp32)]
    assert moved == {key: ts.launches_per_step(B, fp32_caches=fp32)}
    assert {fn for fn, _ in seen} == {ts._LIBRARIES[cdt]}
    assert [n for _, n in seen] == ([B] if fp32 else
                                    [min(ts.MAX_B, B - b0) for b0 in range(0, B, ts.MAX_B)])
