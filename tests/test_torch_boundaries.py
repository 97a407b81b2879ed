"""Boundaries of the PyTorch port: what it imports and where it runs.

- ``infernos_tpu_torch`` and every submodule import neither ``jax`` nor
  anything of ``infernos_tpu`` (checked in a fresh interpreter, and in the
  source text), and neither does ``chip_smoke.py``;
- ``default_device()`` raises when there is no CUDA device;
- on a CUDA tensor the kernel wrappers launch their kernel or raise: the
  dispatch has no route from a CUDA tensor to the plain version and no
  ``try`` that could fall back (read from the code, since there is no card
  here), and the kernel side refuses tensors it cannot take;
- a quantized tree packs to int8 codes and there is no route from it to the
  bf16 kernels by dequantizing;
- the engines, the tiered facade and ``NeuralVAD`` raise without a card
  unless ``device="cpu"`` is passed.
"""

import ast
import inspect
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import infernos_tpu_torch
from infernos_tpu_torch.ops import attention as attn
from infernos_tpu_torch.ops import tts_step as ts
from infernos_tpu_torch.utils import platform

PKG = Path(infernos_tpu_torch.__file__).parent
ROOT = PKG.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)],
                                                         "infernos_tpu_torch."))


def test_every_submodule_imports_without_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'infernos_tpu' or m.startswith('infernos_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []
    assert len(_modules()) >= 40
    for m in ("models.quant", "models.vad", "serving.vad_engine", "serving.sessions",
              "serving.stt_tiered", "serving.driver", "serving.batcher",
              "t2t.translator", "t2t.lexicon", "t2t.numbers", "t2t.sentences",
              "audio.chunk", "audio.markers", "audio.resample", "audio.codecs.g711",
              "audio.codecs.base", "utils.threads", "utils.logging", "utils.metrics"):
        assert f"infernos_tpu_torch.{m}" in _modules()


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.name)
def test_no_source_imports_jax_or_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "infernos_tpu"), f"{path}: {n}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.default_device()
    assert platform.default_device("cpu") == torch.device("cpu")


def _cuda_branch_calls(fn):
    """Names called in the ``... == "cuda"`` branch of ``fn`` and whether
    the function holds any ``try``."""
    tree = ast.parse(inspect.getsource(fn))
    has_try = any(isinstance(n, ast.Try) for n in ast.walk(tree))
    calls = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.IfExp)) and "'cuda'" in ast.dump(node.test):
            for sub in ast.walk(ast.Module(body=node.body if isinstance(node, ast.If)
                                           else [ast.Expr(node.body)],
                                           type_ignores=[])):
                if isinstance(sub, (ast.Call, ast.Name)):
                    name = sub.func if isinstance(sub, ast.Call) else sub
                    if isinstance(name, ast.Name):
                        calls.add(name.id)
    return calls, has_try


@pytest.mark.parametrize("fn,kernel,plain", [
    (attn.fused_attention, "_kernel_attention", "_plain_attention"),
    (ts.fused_decode_step, "_kernel_decode_step", "_plain_decode_step"),
])
def test_cuda_dispatch_never_routes_to_plain(fn, kernel, plain):
    calls, has_try = _cuda_branch_calls(fn)
    assert kernel in calls and plain not in calls
    assert not has_try
    for f in (attn._kernel_attention, ts._kernel_decode_step):
        assert not any(isinstance(n, ast.Try)
                       for n in ast.walk(ast.parse(inspect.getsource(f))))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel side never computes on a CPU tensor (it raises before
    building or launching anything)."""
    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attn._kernel_attention(q, q, q, torch.zeros((2, 16)))
    before = attn.fused_attention.launches
    attn.fused_attention(torch.zeros((1, 16, 128)), torch.zeros((1, 16, 128)),
                         torch.zeros((1, 16, 128)), n_heads=2)
    assert attn.fused_attention.launches == before  # plain path: no launch


def test_kernel_decode_step_refuses_cpu_tensors_in_both_modes():
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.models.quant import quantize_params

    cfg = st5.SpeechT5Config(hidden_size=128, decoder_layers=1, encoder_layers=1,
                             decoder_attention_heads=2, encoder_attention_heads=2,
                             decoder_ffn_dim=256, encoder_ffn_dim=256)
    params = st5.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # shapes and dtypes the kernel takes, so only the device is refused
    cache = st5.init_cache(cfg, 2, 8, 4, "cpu", dtype=torch.bfloat16)
    x, pos = torch.zeros((2, 1, 128)), torch.zeros(2, dtype=torch.long)
    before = (ts.fused_decode_step.launches, ts.fused_decode_step.launches_int8)
    for tree in (params, quantize_params(params, min_size=0)):
        fw = ts.pack_fused_weights(tree, cfg, torch.bfloat16)
        fw.update({n: ts.pack_panels(fw[n]) for n in ts._GEMMS})  # the card's layout
        with pytest.raises(ValueError, match="CUDA"):
            ts._kernel_decode_step(fw, cfg, x, cache, pos)
        ts.fused_decode_step(tree, cfg, x, cache, pos, packed=fw)  # plain path
    assert (ts.fused_decode_step.launches,
            ts.fused_decode_step.launches_int8) == before  # no launch counted


def test_quantized_tree_never_reaches_the_bf16_kernels():
    """A quantized tree packs to int8 whatever dtype is asked for, the
    wrapper picks the C entry point by that dtype alone, and nothing in the
    kernel wrapper or the packer widens codes to a floating weight."""
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.models.quant import quantize_params

    cfg = st5.SpeechT5Config(hidden_size=64, decoder_layers=1, encoder_layers=1,
                             decoder_attention_heads=1, encoder_attention_heads=1,
                             decoder_ffn_dim=64, encoder_ffn_dim=64)
    q = quantize_params(st5.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                        min_size=0)
    for dtype in (None, torch.bfloat16, torch.float32):
        fw = ts.pack_fused_weights(q, cfg, dtype)
        assert ts.is_int8(fw)
        assert all(fw[n].dtype == torch.int8 for n in ("wqkv", "wso", "wcq", "wco", "w1", "w2"))
        assert all(fw[n].dtype == torch.float32 for n in ts._SCALES)
    src = inspect.getsource(ts._kernel_decode_step)
    assert "tts_decode_step_int8 if int8w else lib.tts_decode_step" in src
    names = {n.id for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Name)} | \
        {n.attr for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Attribute)}
    for banned in ("_plain_decode_step", "matmul", "linear", "compile",
                   "bfloat16_", "einsum", "mm", "bmm"):
        assert banned not in names


@pytest.mark.parametrize("what", ["stt", "tts", "tiered", "vad"])
def test_entry_points_demand_a_card_unless_cpu_is_asked(monkeypatch, what):
    from infernos_tpu_torch.models import hifigan as hfg
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.models import vad
    from infernos_tpu_torch.models import whisper as wsp
    from infernos_tpu_torch.serving import stt_engine as stt
    from infernos_tpu_torch.serving import stt_tiered as tier
    from infernos_tpu_torch.serving import tts_engine as tts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    if what in ("stt", "tiered"):
        cfg = wsp.WhisperConfig(vocab_size=32, num_mel_bins=8, d_model=16,
                                encoder_layers=1, encoder_attention_heads=2,
                                decoder_layers=1, decoder_attention_heads=2, ffn_dim=16,
                                max_source_positions=50, max_target_positions=16,
                                eos_token_id=2, sot_token_id=3, no_speech_token_id=4)
        params = wsp.init_params(cfg, g, "cpu")
        ecfg = stt.STTEngineConfig(batch_slots=1, buckets_s=(1,), max_new_tokens=2,
                                   max_prompt_tokens=8, lang_tokens={"en": 5},
                                   task_transcribe=6, task_translate=7,
                                   no_timestamps=8, no_speech=4)
        if what == "stt":
            make = lambda **kw: stt.STTEngine(params, cfg, ecfg, **kw)
        else:
            make = lambda **kw: tier.TieredSTTEngine(
                params, cfg, tier.TieredSTTConfig(short_max_s=1, short_slots=1,
                                                  long_slots=1, base=ecfg), **kw)
    elif what == "tts":
        cfg = st5.SpeechT5Config(vocab_size=16, hidden_size=16, encoder_layers=1,
                                 encoder_attention_heads=1, encoder_ffn_dim=16,
                                 decoder_layers=1, decoder_attention_heads=1,
                                 decoder_ffn_dim=16, num_mel_bins=4,
                                 speech_decoder_prenet_units=8,
                                 speech_decoder_postnet_units=8,
                                 speaker_embedding_dim=4, max_text_positions=8,
                                 max_speech_positions=16)
        vcfg = hfg.HifiGanConfig(model_in_dim=4, upsample_initial_channel=8)
        params, vparams = st5.init_params(cfg, g, "cpu"), hfg.init_params(vcfg, g, "cpu")
        ecfg = tts.TTSEngineConfig(batch_slots=1, max_text_tokens=4, max_steps=4)
        make = lambda **kw: tts.TTSEngine(params, cfg, vparams, vcfg, ecfg, **kw)
    else:
        params = vad.init_params(vad.VADConfig(), g, "cpu")
        make = lambda **kw: vad.NeuralVAD(params, vad.VADConfig(), 2, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_sessions_run_on_whatever_engine_they_are_given():
    """The session classes hold no device of their own: they neither pick
    one nor move anything; the engine they wrap decides (and raises)."""
    from infernos_tpu_torch.serving import sessions

    src = inspect.getsource(sessions)
    assert "device" not in src and "cuda" not in src and "import torch" not in src
