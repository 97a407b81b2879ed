"""Port's encoder attention (plain path on CPU) vs the JAX reference.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.  Here the port's ``fused_attention`` on CPU
tensors is held against the JAX Pallas kernel (interpret mode) and the JAX
XLA path, on the cases of ``tests/test_ops.py``.  fp32 throughout, so the
tolerance is fp32 round-off: atol/rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from infernos_tpu.ops.attention import fused_attention as jax_fused_attention
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
