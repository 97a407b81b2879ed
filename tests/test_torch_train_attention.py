"""Reverse mode through the encoder attention: the port's ``KernelAttention``
against the reference's ``custom_vjp`` (``infernos_tpu/ops/attention.py:80-98``).

The kernel runs only on the card.  Here the Function's forward is the plain
attention or a stand-in for the kernel (a result with no autograd graph, as
the ctypes launch gives), and its backward -- the reference's: the plain
attention recomputed in fp32 and differentiated -- is held to
``jax.grad`` through the reference's Pallas path in interpret mode, with and
without a key mask (1e-5 relative L2), and to autograd of the plain version.
On the parent, the card's path handed back the kernel's output with no
``grad_fn``, so ``loss.backward()`` through ``whisper.encode`` left the
encoder's q/k/v weights without a gradient; the last tests show they get one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infernos_tpu.ops.attention import fused_attention as jax_fused_attention
from infernos_tpu_torch.ops import attention as attn

REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, D, seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        lens = rng.integers(S // 3, S + 1, B)
        mask = np.arange(S)[None] < lens[:, None]
    return q, k, v, g, mask


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) /
                 max(np.linalg.norm(np.asarray(b)), 1e-30))


def _reference_grads(q, k, v, g, mask, H):
    """dq, dk, dv of <fused_attention(q, k, v), g> through the reference's
    Pallas kernel (interpret mode) and its custom_vjp."""
    jm = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        out = jax_fused_attention(q_, k_, v_, n_heads=H, mask=jm, use_pallas=True,
                                  interpret=True, block_q=64)
        return jnp.sum(out * jnp.asarray(g))

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _plain_forward(q, k, v, mask_add, *, n_heads):
    return attn.by_heads(attn._plain_attention, q, k, v, n_heads=n_heads, mask_add=mask_add)


def _kernel_stand_in(q, k, v, mask_add, *, n_heads):
    """What the ctypes launch hands back: the result, with no graph."""
    with torch.no_grad():
        return _plain_forward(q, k, v, mask_add, n_heads=n_heads)


def _port_grads(q, k, v, g, mask, H, forward_fn):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    mask_add = None if mask is None else attn._mask_add(torch.from_numpy(mask))
    out = attn.KernelAttention.apply(*t, mask_add, H, forward_fn)
    assert out.grad_fn is not None
    (out * torch.from_numpy(g)).sum().backward()
    return [x.grad.numpy() for x in t]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("forward_fn", [_plain_forward, _kernel_stand_in],
                         ids=["plain_forward", "kernel_stand_in"])
def test_gradients_match_the_reference_custom_vjp(masked, forward_fn):
    H = 4
    q, k, v, g, mask = _inputs(2, 100, H * 64, 0 if masked else 1, masked)
    want = _reference_grads(q, k, v, g, mask, H)
    got = _port_grads(q, k, v, g, mask, H, forward_fn)
    for name, a, b in zip("qkv", got, want):
        assert _rel(a, b) <= REL, (name, _rel(a, b))


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_path_gradients_match_the_reference_custom_vjp(masked):
    """``fused_attention`` on CPU tensors (the plain path) under autograd."""
    H = 2
    q, k, v, g, mask = _inputs(3, 70, H * 64, 2, masked)
    want = _reference_grads(q, k, v, g, mask, H)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attn.fused_attention(*t, n_heads=H,
                               mask=None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    for name, a, b in zip("qkv", [x.grad.numpy() for x in t], want):
        assert _rel(a, b) <= REL, (name, _rel(a, b))


@pytest.mark.parametrize("masked", [False, True])
def test_function_backward_equals_autograd_of_the_plain_version(masked):
    """The Function with the plain attention injected as its forward: its
    output and gradients equal autograd through the plain version itself;
    the mask gets no gradient (the reference returns zeros for it)."""
    H = 4
    q, k, v, g, mask = _inputs(2, 33, H * 64, 3, masked)
    mask_add = attn._mask_add(torch.from_numpy(mask)) if masked else None
    a = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    b = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    out_f = attn.KernelAttention.apply(*a, mask_add, H, _plain_forward)
    out_p = _plain_forward(*b, mask_add, n_heads=H)
    torch.testing.assert_close(out_f, out_p, rtol=0, atol=0)
    gt = torch.from_numpy(g).double()
    (out_f * gt).sum().backward()
    (out_p * gt).sum().backward()
    for x, y in zip(a, b):
        # the Function's backward recomputes in fp32, as the reference does
        assert x.grad.dtype == torch.float64
        assert _rel(x.grad.numpy(), y.grad.numpy()) <= REL


def test_card_dispatch_takes_the_function_only_under_grad(monkeypatch):
    """On the card ``fused_attention`` hands the kernel to
    :class:`KernelAttention` when grad mode is on and an input requires
    grad; in serving (no grad) it launches the kernel as before."""
    seen = []

    class FakeFunction:
        @staticmethod
        def apply(*args):
            seen.append(("function", args))
            return "out"

    def fake_kernel(q, k, v, mask_add=None, *, n_heads=1):
        seen.append(("kernel", (q, k, v, mask_add, n_heads)))
        return "out"

    class OnCard:
        device = torch.device("cuda", 0)

        def __init__(self, rg):
            self.requires_grad = rg

    monkeypatch.setattr(attn, "KernelAttention", FakeFunction)
    monkeypatch.setattr(attn, "_kernel_attention", fake_kernel)
    q, k, v = OnCard(True), OnCard(False), OnCard(False)
    attn.fused_attention(q, k, v, n_heads=4)
    with torch.no_grad():
        attn.fused_attention(q, k, v, n_heads=4)
    attn.fused_attention(OnCard(False), OnCard(False), OnCard(False), n_heads=4)
    assert [s[0] for s in seen] == ["function", "kernel", "kernel"]
    assert seen[0][1] == (q, k, v, None, 4)


def test_encoder_qkv_weights_get_gradients_through_the_kernel_route(monkeypatch):
    """The repaired fault: the encoder's attention as the card runs it in
    training (the kernel -- here its stand-in -- inside ``KernelAttention``)
    gives every encoder q/k/v weight a finite, nonzero gradient, equal to
    the plain path's; the stand-in alone, as the parent ran it, gives none."""
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.tools import optim

    cfg = wsp.WhisperConfig(vocab_size=64, num_mel_bins=16, d_model=128,
                            encoder_layers=2, encoder_attention_heads=2,
                            decoder_layers=1, decoder_attention_heads=2, ffn_dim=128,
                            max_source_positions=40, max_target_positions=8)
    params = optim.trainable(wsp.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    mel = torch.randn((2, 16, 80), generator=torch.Generator().manual_seed(1))
    qkv = [params["enc_layers"]["attn"][n]["w"] for n in "qkv"]

    def grads(route):
        monkeypatch.setattr(wsp, "fused_attention", route)
        out = wsp.encode(params, cfg, mel)
        return torch.autograd.grad(out.square().sum(), qkv, allow_unused=True)

    def card_training(q, k, v, *, n_heads, mask=None):
        return attn.KernelAttention.apply(q, k, v, None, n_heads, _kernel_stand_in)

    def parent_card(q, k, v, *, n_heads, mask=None):
        return _kernel_stand_in(q, k, v, None, n_heads=n_heads)

    got = grads(card_training)
    want = grads(attn.fused_attention)  # the plain CPU path, autograd throughout
    for gw, ww in zip(got, want):
        assert gw is not None and torch.isfinite(gw).all()
        assert (gw[0].abs().sum() > 0) and (gw[1].abs().sum() > 0)  # both layers
        assert _rel(gw.numpy(), ww.numpy()) <= REL
    assert grads(parent_card) == (None, None, None)
