"""The port's checkpoints (``models/checkpoint.py``), ``npz_io.save_params``,
``amendnet.init_params``, the speaker bank's loaders and the offline port
rehearsal (``tools/port_checkpoints.py --dry-run``), against the JAX
package where it has the same function, on the CPU.

- Round trip of ``QWEN_TINY`` into a ``like`` with other values, bit-equal,
  and ``load_config`` (port copy of ``tests/test_bench_ckpt.py::
  test_checkpoint_roundtrip``); bf16 and int8 leaves keep their dtype.
- A missing key or a wrong shape raises ``ValueError`` naming the key.
- A ``params.npz`` written by the JAX ``checkpoint.save`` fallback (orbax
  made unimportable) loads into the port with equal values, fp32 and int8.
- ``npz_io.save_params`` files read back by both packages' ``load_params``.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from infernos_tpu.models import amendnet as jamd
from infernos_tpu.models import checkpoint as jckpt
from infernos_tpu.models import npz_io as jnpz
from infernos_tpu.models import presets as jpresets
from infernos_tpu.models import quant as jquant
from infernos_tpu.models import qwen as jq
from infernos_tpu.serving.speakers import SpeakerBank as JSpeakerBank
from infernos_tpu_torch.models import amendnet as amd
from infernos_tpu_torch.models import checkpoint as ckpt
from infernos_tpu_torch.models import npz_io, presets, quant, qwen
from infernos_tpu_torch.serving.speakers import SpeakerBank
from infernos_tpu_torch.tools import port_checkpoints


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _leaves(tree):
    return [t for _, t in ckpt.flatten(tree)]


def test_checkpoint_roundtrip(tmp_path):
    cfg = presets.QWEN_TINY
    params = qwen.init_params(cfg, _gen(0), "cpu")
    ckpt.save(str(tmp_path / "m"), params, config=cfg)
    like = qwen.init_params(cfg, _gen(1), "cpu")  # other values
    loaded = ckpt.load(str(tmp_path / "m"), like)
    assert [k for k, _ in ckpt.flatten(loaded)] == [k for k, _ in ckpt.flatten(params)]
    for a, b in zip(_leaves(params), _leaves(loaded)):
        assert torch.equal(a, b)
    cfg2 = ckpt.load_config(str(tmp_path / "m"), type(cfg))
    assert cfg2 == cfg


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_dtypes_are_kept(tmp_path, mode):
    from infernos_tpu_torch.models.convert import cast_floating

    tree = cast_floating(qwen.init_params(presets.QWEN_TINY, _gen(0), "cpu"), torch.bfloat16)
    if mode == "int8":
        tree = quant.quantize_params(tree, min_size=1)
    ckpt.save(str(tmp_path), tree)
    back = ckpt.load(str(tmp_path), tree)
    dtypes = {t.dtype for t in _leaves(back)}
    assert dtypes == ({torch.bfloat16} if mode == "bf16"
                      else {torch.bfloat16, torch.int8, torch.float32})
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_missing_key_and_wrong_shape_raise(tmp_path):
    cfg = presets.QWEN_TINY
    params = qwen.init_params(cfg, _gen(0), "cpu")
    ckpt.save(str(tmp_path), {k: v for k, v in params.items() if k != "ln_f"})
    with pytest.raises(ValueError, match="ln_f/g"):
        ckpt.load(str(tmp_path), params)
    wide = qwen.init_params(dataclasses.replace(cfg, intermediate_size=128), _gen(0), "cpu")
    ckpt.save(str(tmp_path), params)
    with pytest.raises(ValueError, match="layers/gate/w.*want \\(2, 48, 128\\)"):
        ckpt.load(str(tmp_path), wide)


@pytest.mark.parametrize("int8", [False, True])
def test_loads_the_reference_npz_fallback(tmp_path, monkeypatch, int8):
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)  # forces the npz path
    cfg = jpresets.QWEN_TINY
    jparams = jq.init_params(jax.random.PRNGKey(0), cfg)
    like = qwen.init_params(presets.QWEN_TINY, _gen(0), "cpu")
    if int8:
        jparams = jquant.quantize_params(jparams)
        like = quant.quantize_params(like)
    jckpt.save(str(tmp_path), jparams, cfg)
    assert os.path.exists(tmp_path / "params.npz") and not os.path.exists(tmp_path / "params")
    back = ckpt.load(str(tmp_path), like)
    want = {k: np.asarray(v) for k, v in ckpt.flatten(jax.tree_util.tree_map(np.asarray, jparams))}
    got = dict(ckpt.flatten(back))
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert ckpt.load_config(str(tmp_path), qwen.QwenConfig) == presets.QWEN_TINY


def test_save_params_reads_back_in_both_packages(tmp_path):
    tree = amd.init_params(amd.AmendNetConfig(), _gen(3), "cpu")
    tree["lists"] = [{"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
                     {"w": torch.ones(2, dtype=torch.bfloat16)}]
    path = str(tmp_path / "sub" / "p.npz")
    npz_io.save_params(path, tree)
    mine = npz_io.load_params(path, "cpu")
    ref = jnpz.load_params(path)
    flat = dict(ckpt.flatten(tree))
    assert dict(ckpt.flatten(mine)).keys() == flat.keys()
    for k, t in ckpt.flatten(mine):
        np.testing.assert_array_equal(t.numpy(), flat[k].float().numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(leaf_at(ref, k)), t.numpy(), err_msg=k)


def leaf_at(tree, key):
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def test_amendnet_init_params_is_identity():
    cfg = amd.AmendNetConfig()
    p = amd.init_params(cfg, _gen(0), "cpu")
    jp = jamd.init_params(jax.random.PRNGKey(0), cfg)
    shapes = {k: tuple(v.shape) for k, v in ckpt.flatten(p)}
    assert shapes == {k: tuple(np.shape(v)) for k, v in
                      ckpt.flatten(jax.tree_util.tree_map(np.asarray, jp))}
    for name, c_in in (("conv1", cfg.num_mels + cfg.frame_size), ("conv2", cfg.hidden)):
        bound = 1.0 / np.sqrt(c_in * 3)
        for leaf in p[name].values():
            assert float(leaf.abs().max()) <= bound and float(leaf.std()) > bound / 4
    assert all(float(v.abs().max()) == 0.0 for v in p["out"].values())
    rng = np.random.default_rng(0)
    T = cfg.total_frames
    mel = torch.tensor(rng.standard_normal((2, T, cfg.num_mels)).astype(np.float32))
    audio = torch.tensor(0.3 * rng.standard_normal((2, T * cfg.frame_size)).astype(np.float32))
    out = amd.apply(p, cfg, mel, audio)
    s, e = cfg.pre_frames * cfg.frame_size, (cfg.pre_frames + cfg.chunk_frames) * cfg.frame_size
    np.testing.assert_array_equal(out.numpy(), torch.tanh(audio[:, s:e]).numpy())
    jout = jamd.apply(jax.tree_util.tree_map(lambda t: t.numpy(), p), cfg, mel.numpy(),
                      audio.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)


def test_speaker_bank_loaders_equal_the_reference(tmp_path):
    vecs = np.random.default_rng(5).standard_normal((40, 16)).astype(np.float32)
    path = str(tmp_path / "xvectors.npz")
    np.savez_compressed(path, xvectors=vecs)
    for mine, ref in ((SpeakerBank.from_npz(path), JSpeakerBank.from_npz(path)),
                      (SpeakerBank.load(path), JSpeakerBank.load(path)),
                      (SpeakerBank.load(str(tmp_path / "absent.npz"), dim=16),
                       JSpeakerBank.load(str(tmp_path / "absent.npz"), dim=16))):
        np.testing.assert_array_equal(mine.vectors, ref.vectors)
        for lang in ("en", "pt", "es"):  # hash(lang): equal within one process only
            assert mine.top_speakers(lang, n=10) == ref.top_speakers(lang, n=10)
        assert mine.top_speakers("en", n=100) == ref.top_speakers("en", n=100)
    assert len(SpeakerBank.load(None)) == len(JSpeakerBank.load(None))


def test_dry_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("INFERNOS_DEVICE", "cpu")
    torch.set_num_threads(2)
    assert port_checkpoints.main(["--dry-run", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "dry-run OK: save/load/tokenize/infer/detokenize all offline on cpu" in out
    assert "-> 'hello world'" in out
    for d in ("whisper", "tts_en", "qwen"):
        assert os.path.exists(tmp_path / d / "params.pt")
        assert os.path.exists(tmp_path / d / "config.json")
    assert port_checkpoints.main(["--stt"]) == 2
