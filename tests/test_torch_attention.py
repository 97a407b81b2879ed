"""Port's encoder attention (plain path on CPU) vs the JAX reference.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.  Here the port's ``fused_attention`` on CPU
tensors is held against the JAX Pallas kernel (interpret mode) and the JAX
XLA path, on the cases of ``tests/test_ops.py``.  fp32 throughout, so the
tolerance is fp32 round-off: atol/rtol 1e-5.

The kernel's wrapper checks its inputs before it looks at the device, so
what it refuses (type, strides, alignment, shapes) is exercised here with
CPU tensors; a well-formed CPU tensor gets as far as the device check.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from infernos_tpu.ops.attention import fused_attention as jax_fused_attention
from infernos_tpu_torch.ops import attention as attn
from infernos_tpu_torch.ops.attention import _plain_attention, fused_attention

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(3)]


def _both(q, k, v, mask=None, H=4):
    t = lambda a: torch.from_numpy(a)
    got = fused_attention(t(q), t(k), t(v), n_heads=H,
                          mask=None if mask is None else t(mask)).numpy()
    jm = None if mask is None else jnp.asarray(mask)
    pallas = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 n_heads=H, mask=jm, use_pallas=True,
                                 interpret=True)
    xla = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              n_heads=H, mask=jm, use_pallas=False)
    return got, np.asarray(pallas), np.asarray(xla)


def test_no_mask_matches_jax():
    got, pallas, xla = _both(*_qkv(2, 256, 64, 0))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


def test_mask_matches_jax_and_hides_keys():
    q, k, v = _qkv(2, 256, 64, 1)
    mask = np.ones((2, 256), bool)
    mask[0, 200:] = False
    got, pallas, xla = _both(q, k, v, mask)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)
    k2, v2 = k.copy(), v.copy()
    k2[0, 200:], v2[0, 200:] = 99.0, -99.0
    got2, _, _ = _both(q, k2, v2, mask)
    np.testing.assert_allclose(got2, got, **TOL)


@pytest.mark.parametrize("S", [400, 1500, 130, 128])
def test_unaligned_seq_lens_match_jax(S):
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((2, S, 64)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(S)[None, :] < np.array([[S - 7], [S]])
    got, pallas, xla = _both(q, k, v, mask)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


def test_plain_attention_head_layout():
    """``_plain_attention`` on [BH, S, Dh] is what fused_attention splits into."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 128, 64, 3))
    split = lambda x: x.reshape(1, 128, 4, 16).transpose(1, 2).reshape(4, 128, 16)
    want = _plain_attention(split(q), split(k), split(v),
                            torch.zeros(4, 128)).reshape(1, 4, 128, 16)
    want = want.transpose(1, 2).reshape(1, 128, 64)
    got = fused_attention(q, k, v, n_heads=4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("B,S,H", [(3, 200, 4), (4, 129, 2), (2, 64, 1)])
def test_per_batch_key_mask_matches_jax(B, S, H):
    """B > 1, a different number of valid keys per batch element (the
    kernel's mask contract: one ``[S]`` row per batch element, shared by its
    heads).  fp32 on both sides: 1e-5."""
    rng = np.random.default_rng(10 * B + S)
    q, k, v = (rng.standard_normal((B, S, 64 * H)).astype(np.float32)
               for _ in range(3))
    lens = rng.integers(1, S + 1, size=B)
    lens[-1] = S
    mask = np.arange(S)[None, :] < lens[:, None]
    got, pallas, xla = _both(q, k, v, mask, H=H)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)
    # a masked key changes nothing, in its own batch element or another
    b = int(np.argmin(lens))
    if lens[b] < S:
        k2, v2 = k.copy(), v.copy()
        k2[b, lens[b]:], v2[b, lens[b]:] = 50.0, -50.0
        got2, _, _ = _both(q, k2, v2, mask, H=H)
        np.testing.assert_allclose(got2, got, **TOL)


@pytest.mark.parametrize("B,S,H", [(3, 200, 4), (1, 1500, 2), (5, 65, 1)])
def test_mask_none_matches_jax_and_all_true_mask(B, S, H):
    """``mask=None`` (the encoder's call) against JAX, and against an
    all-True mask.  fp32: 1e-5."""
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.standard_normal((B, S, 64 * H)).astype(np.float32)
               for _ in range(3))
    got, pallas, xla = _both(q, k, v, None, H=H)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)
    full, _, _ = _both(q, k, v, np.ones((B, S), bool), H=H)
    np.testing.assert_allclose(got, full, **TOL)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _bad_inputs():
    """name -> (q, k, v, mask_add, n_heads, message) the kernel refuses."""
    ok = _bf16(2, 16, 128)
    wide = _bf16(2, 16, 132)
    flat = _bf16(2 * 16 * 128 + 4)
    return {
        "fp32": (ok.float(), ok, ok, None, 2, "bf16"),
        "fp16_v": (ok, ok, ok.half(), None, 2, "v must be bf16"),
        "last_stride": (_bf16(2, 128, 16).transpose(1, 2), ok, ok, None, 2,
                        "last stride"),
        "row_stride": (ok, wide[:, :, :128], ok, None, 2, "16-byte aligned"),
        "pointer": (ok, ok, flat[4:].view(2, 16, 128), None, 2,
                    "16-byte aligned"),
        "batch_stride": (torch.as_strided(_bf16(2 * (16 * 128 + 4)),
                                          (2, 16, 128), (16 * 128 + 4, 128, 1)),
                         ok, ok, None, 2, "16-byte aligned"),
        "head_dim": (_bf16(2, 16, 64), _bf16(2, 16, 64), _bf16(2, 16, 64),
                     None, 2, "head dim"),
        "shapes": (ok, _bf16(2, 15, 128), ok, None, 2, "shapes differ"),
        "mask_dtype": (ok, ok, ok, torch.zeros((2, 16), dtype=torch.float64),
                       2, "mask_add"),
        "mask_per_head": (ok, ok, ok, torch.zeros((4, 16)), 2, "mask_add"),
        "mask_strided": (ok, ok, ok, torch.zeros((2, 32))[:, ::2], 2,
                         "mask_add"),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_kernel_wrapper_refuses(case):
    q, k, v, mask_add, H, msg = _bad_inputs()[case]
    before = attn.fused_attention.launches
    with pytest.raises(ValueError, match=msg):
        attn._kernel_attention(q, k, v, mask_add, n_heads=H)
    assert attn.fused_attention.launches == before


def test_kernel_wrapper_takes_heads_in_place():
    """Views the kernel reads in place pass every check but the device's:
    thirds of a fused ``[B, S, 3D]`` projection, a batch slice, and the
    ``[BH, S, 64]`` layout; the strides handed to the kernel are the
    tensor's own (batch, head = 64, row)."""
    qkv = _bf16(2, 16, 3 * 128)
    q, k, v = qkv.split(128, dim=-1)
    assert attn._kernel_args(q, k, v, torch.zeros((2, 16)), 2) == (
        2, 16, [16 * 384, 64, 384] * 3)
    with pytest.raises(ValueError, match="CUDA"):
        attn._kernel_attention(q, k, v, torch.zeros((2, 16)), n_heads=2)
    x = _bf16(4, 16, 128)[1:3]
    assert attn._kernel_args(x, x, x, None, 2) == (2, 16, [2048, 64, 128] * 3)
    bh = _bf16(6, 10, 64)
    assert attn._kernel_args(bh, bh, bh, torch.zeros((6, 10)), 1) == (
        6, 10, [640, 64, 64] * 3)


def test_cuda_branch_builds_no_mask_and_no_copies(monkeypatch):
    """On the card ``fused_attention`` hands q, k, v to the kernel as they
    are and passes no mask tensor when ``mask`` is None (read from the call,
    with the kernel side replaced: there is no card here)."""
    seen = {}

    def fake_kernel(q, k, v, mask_add=None, *, n_heads=1):
        seen.update(q=q, k=k, v=v, mask_add=mask_add, n_heads=n_heads)
        return q

    class OnCard:  # a tensor stand-in that says it lies on the card
        device = torch.device("cuda", 0)

    q, k, v = OnCard(), OnCard(), OnCard()
    monkeypatch.setattr(attn, "_kernel_attention", fake_kernel)
    assert fused_attention(q, k, v, n_heads=20) is q
    assert seen["q"] is q and seen["k"] is k and seen["v"] is v
    assert seen["mask_add"] is None and seen["n_heads"] == 20
    fused_attention(q, k, v, n_heads=20,
                    mask=torch.tensor([[True, False, True]]))
    np.testing.assert_array_equal(seen["mask_add"].numpy(),
                                  np.float32([[0.0, attn.NEG_INF, 0.0]]))
    assert seen["mask_add"].dtype == torch.float32
