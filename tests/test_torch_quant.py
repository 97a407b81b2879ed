"""Port's int8 weight-only quantization vs ``infernos_tpu.models.quant``.

Same numpy weights through both: the int8 codes must be identical (same
fp32 arithmetic, round-half-even in both), the scales equal to 1e-6
relative, and ``layers.linear`` on a quantized node equal to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from infernos_tpu.models import layers as jL
from infernos_tpu.models import quant as jq
from infernos_tpu.models import speecht5 as jst5
from infernos_tpu_torch.models import layers as L
from infernos_tpu_torch.models import quant as q
from infernos_tpu_torch.models.convert import cast_floating, from_jax_params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(32, 48), (3, 32, 48), (5, 7), (2, 64, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_quantize_linear_codes_exact_scales_close(shape, bias):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0, :] *= 10.0  # an outlier row: the per-channel maxima differ
    w[..., :, -1] = 0.0   # an all-zero output channel: the 1e-8 floor
    node = {"w": w}
    if bias:
        node["b"] = rng.standard_normal(shape[:-2] + shape[-1:]).astype(np.float32)
    want = _np(jq.quantize_linear({k: jnp.asarray(v) for k, v in node.items()}))
    got = q.quantize_linear({k: torch.from_numpy(v) for k, v in node.items()})
    assert set(got) == set(want)
    assert got["w_q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_q"].numpy(), want["w_q"])
    np.testing.assert_allclose(got["scale"].numpy(), want["scale"], rtol=1e-6, atol=0)
    if bias:
        np.testing.assert_array_equal(got["b"].numpy(), want["b"])


CFG_KW = dict(
    vocab_size=40, hidden_size=64, encoder_layers=1,
    encoder_attention_heads=4, encoder_ffn_dim=96, decoder_layers=2,
    decoder_attention_heads=4, decoder_ffn_dim=96, num_mel_bins=8,
    speech_decoder_prenet_units=16, speech_decoder_postnet_units=16,
    speaker_embedding_dim=16, max_text_positions=16, max_speech_positions=64)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("min_size,exclude", [
    (4096, q.DEFAULT_EXCLUDE), (0, q.DEFAULT_EXCLUDE), (0, ("enc_layers", "ffn")),
    (2000, ())], ids=["default", "min0", "exclude-enc-ffn", "min2000-noexcl"])
def test_quantize_params_same_tree_as_jax(min_size, exclude):
    assert q.DEFAULT_EXCLUDE == jq.DEFAULT_EXCLUDE
    jparams = jst5.init_params(jax.random.PRNGKey(1), jst5.SpeechT5Config(**CFG_KW))
    want = dict(_paths(_np(jq.quantize_params(jparams, min_size, exclude))))
    got = dict(_paths(q.quantize_params(from_jax_params(_np(jparams), "cpu"),
                                        min_size, exclude)))
    assert set(got) == set(want)
    n_q = 0
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype, path
        if path.endswith("/w_q"):
            n_q += 1
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=path)
    if min_size == 0 and exclude == q.DEFAULT_EXCLUDE:
        assert n_q >= 10  # stacked decoder and encoder matrices, prenet, heads
        assert "/postnet/0/conv/w" in want and "/text_embed/w" in want
    assert q.quantized_bytes(q.quantize_params(
        from_jax_params(_np(jparams), "cpu"), min_size, exclude)) == \
        jq.quantized_bytes(jq.quantize_params(jparams, min_size, exclude))


@pytest.mark.parametrize("lead", [(5,), (2, 3)], ids=["2d", "3d"])
def test_linear_on_quantized_node_matches_jax(lead):
    rng = np.random.default_rng(3)
    node = {"w": rng.standard_normal((24, 40)).astype(np.float32),
            "b": rng.standard_normal(40).astype(np.float32)}
    x = rng.standard_normal(lead + (24,)).astype(np.float32)
    jnode = jq.quantize_linear({k: jnp.asarray(v) for k, v in node.items()})
    want = np.asarray(jL.linear(jnp.asarray(x), jnode))
    tnode = from_jax_params(_np(jnode), "cpu")
    got = L.linear(torch.from_numpy(x), tnode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the port's own quantizer feeds the same product
    own = L.linear(torch.from_numpy(x), q.quantize_linear(
        {k: torch.from_numpy(v) for k, v in node.items()})).numpy()
    np.testing.assert_allclose(own, want, rtol=1e-5, atol=1e-5)


def test_from_jax_params_keeps_int8_codes_and_fp32_scales():
    jnode = jq.quantize_linear({"w": jnp.asarray(
        np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32))})
    for dtype in (None, torch.float32):
        t = from_jax_params(_np(jnode), "cpu", dtype)
        assert t["w_q"].dtype == torch.int8 and t["scale"].dtype == torch.float32
        np.testing.assert_array_equal(t["w_q"].numpy(), np.asarray(jnode["w_q"]))
        np.testing.assert_array_equal(t["scale"].numpy(), np.asarray(jnode["scale"]))


def test_cast_floating_leaves_quantized_scales_fp32():
    """A quantized tree cast to bf16 keeps its scales in fp32 (the kernel
    and the reference's packed weights both want them so); every other
    floating leaf, the node's own bias included, is cast."""
    tree = {"lin": q.quantize_linear({"w": torch.randn(16, 8), "b": torch.randn(8)}),
            "dense": {"w": torch.randn(4, 4), "scale": torch.randn(4)},
            "stack": [q.quantize_linear({"w": torch.randn(2, 16, 8)})]}
    out = cast_floating(tree, torch.bfloat16)
    assert out["lin"]["scale"].dtype == torch.float32
    assert out["stack"][0]["scale"].dtype == torch.float32
    assert out["lin"]["w_q"].dtype == torch.int8
    assert out["lin"]["b"].dtype == torch.bfloat16
    # "scale" outside a quantized node is an ordinary floating leaf
    assert out["dense"]["scale"].dtype == torch.bfloat16
    assert out["dense"]["w"].dtype == torch.bfloat16
    torch.testing.assert_close(out["lin"]["scale"], tree["lin"]["scale"], rtol=0, atol=0)
