"""Boundaries of the PyTorch port: what it imports and where it runs.

- ``infernos_tpu_torch`` and every submodule import neither ``jax`` nor
  anything of ``infernos_tpu`` nor ``transformers`` (checked in a fresh
  interpreter, and in the source text), and neither does ``chip_smoke.py``;
- ``default_device()`` raises when there is no CUDA device;
- on a CUDA tensor the kernel wrappers launch their kernel or raise: the
  dispatch has no route from a CUDA tensor to the plain version and no
  ``try`` that could fall back (read from the code, since there is no card
  here), and the kernel side refuses tensors it cannot take;
- a quantized tree packs to int8 codes and there is no route from it to the
  bf16 kernels by dequantizing;
- the engines, the tiered facade and ``NeuralVAD`` raise without a card
  unless ``device="cpu"`` is passed, and so do the tiny-real loaders, the
  Griffin-Lim parameters and the ingest ring's default VAD;
- a CUDA ``TTSEngine`` is refused at construction with more slots than the
  step kernel takes;
- the native media engine builds under the port's own ``build/`` and names
  no path of the reference's ``native/`` directory;
- the daemon's entry point and a CPU ``build_cluster``/``stop_all`` load no
  ``jax`` or reference module (fresh interpreter), with a LiveTranslator
  and with an AI attendant profile, and ``build_cluster`` demands a card
  unless the CPU is asked;
- the LLM engine, the ``LLMActor`` start and the tiny LLM loader demand a
  card unless the CPU is asked;
- the benches (``bench.ttsmain``, ``bench.ltbench``, ``bench.loopback`` and
  the flagship ``python -m infernos_tpu_torch.bench``) load no ``jax``,
  reference or ``tools`` module, make their inputs without them, demand a
  card unless ``INFERNOS_DEVICE=cpu`` asks for the CPU, and the LT bench
  refuses the tiny random models on a card before it binds anything;
- the engine and attendant benches (``bench.sttbench``, ``ttsbench``,
  ``ttsprobe``, ``llmbench``, ``aiabench``, ``echo``), the sampler
  (``utils.pysampler``) and the STT quality ladder load no ``jax``,
  reference or ``tools`` module either; each bench ``main`` demands a card
  unless ``INFERNOS_DEVICE=cpu`` asks for the CPU and refuses, on a card,
  the tiny dims the kernels do not take;
- the multi-host plane (``cluster/remote.py``) imports the standard library,
  ``torch`` and the port only, and the peers' sources import no ``jax``,
  reference or ``transformers`` module; a peer without a card refuses to
  start a model actor unless ``device="cpu"`` is asked, and the asker sees
  the error; a peer serving a tiny LT call's STT loads none of them;
- the parallel plane (``parallel/mesh.py``, ``ranks.py``, ``budget.py``,
  ``dryrun.py``) and the rank functions of the tensor-parallel tests import
  the standard library, ``numpy``, ``torch`` and the port only; a CPU rank
  process running a tp decode loads no ``jax``, ``jaxlib`` or reference
  module; ``make_mesh``, ``run_ranks`` and the dry run's entry points
  demand a card unless ``device="cpu"`` is asked.
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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'infernos_tpu', 'transformers', 'safetensors', 'huggingface_hub'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []
    assert len(_modules()) >= 40
    for m in ("models.quant", "models.vad", "serving.vad_engine", "serving.sessions",
              "serving.stt_tiered", "serving.driver", "serving.batcher",
              "t2t.translator", "t2t.lexicon", "t2t.numbers", "t2t.sentences",
              "audio.chunk", "audio.markers", "audio.resample", "audio.codecs.g711",
              "audio.codecs.base", "utils.threads", "utils.logging", "utils.metrics",
              "models.bpe", "models.spm", "models.tiny_real", "audio.griffinlim",
              "audio.signals", "audio.muxer", "audio.codecs.g722", "media.rtp",
              "media.jitter", "media.native", "media.udp", "media.rtcp",
              "media.pacer", "media.cpacer", "media.ingest", "media.endpoint",
              "audio.speechlang", "sip.message", "sip.sdp", "sip.stack", "sip.ua",
              "sip.registration", "sip.agent", "cluster.actors", "cluster.rtp_actor", "cluster.remote",
              "cluster.model_actors", "config.config", "config.validator",
              "apps.live_translator.session", "apps.live_translator.actor",
              "models.presets", "utils.metrics_export", "bench.phone", "main",
              "__main__", "audio.synth_speech", "bench.paced_calls", "bench.ttsmain",
              "bench.ltbench", "bench.loopback", "bench.__main__", "utils.pysampler",
              "bench.sttbench", "bench.ttsbench", "bench.ttsprobe", "bench.llmbench",
              "bench.aiabench", "bench.echo", "models.checkpoint", "models.npz_io",
              "models.convert", "models.amendnet", "serving.speakers",
              "tools.port_checkpoints", "parallel", "parallel.mesh", "parallel.ranks",
              "parallel.budget", "parallel.dryrun", "tools.optim", "tools.train_tiny_stt",
              "tools.train_tiny_tts", "tools.train_tiny_llm", "tools.train_vad",
              "tools.train_amendnet", "tools.check_bilingual", "models.hf_snapshot",
              "examples", "examples.llm_test", "examples.tts_stream"):
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


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.name)
def test_no_source_imports_transformers(path):
    """The port converts HF checkpoints from their ``state_dict()`` by key
    name (``port_from_hf``) and reads the hub cache itself
    (``models/hf_snapshot.py``): neither it nor ``chip_smoke.py`` imports
    ``transformers``, ``safetensors`` or ``huggingface_hub``, which the
    card's machine does not have."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert all(n.split(".")[0] not in ("transformers", "safetensors", "huggingface_hub")
                   for n in names), f"{path}: {names}"


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
    # the entry point by the weights' dtype (and the caches'), int8 codes
    # only to the int8 entries
    assert "_MODES[(int8w, cache.self_k.dtype)]" in src
    assert all(entry.startswith("tts_decode_step_int8") == int8w
               for (int8w, _), (entry, _) in ts._MODES.items())
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


def test_chip_smoke_imports_no_jax_or_reference():
    """``chip_smoke.py`` runs on the card's machine, which has no JAX: no
    import of it (at any depth, in any function) names ``jax`` or the
    reference package, and it loads no file of the repo by path."""
    src = (ROOT / "chip_smoke.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "infernos_tpu"), n
    assert "import_module(\"infernos_tpu." not in src
    assert "spec_from_file_location" not in src and "sys.path" not in src


def test_chip_smoke_call_speech_loads_no_jax_or_reference():
    """What ``chip_smoke.py`` runs to make a far end's speech, and to load
    the tiny-real pair, leaves no ``jax`` or reference module loaded."""
    code = (
        "import json, sys\n"
        "import chip_smoke as cs\n"
        "from infernos_tpu_torch.models import tiny_real\n"
        "for ln in cs.CALL_LINES: assert cs.render_speech(ln[4], ln[5]).size > 0\n"
        "if tiny_real.have_tiny_stt(): tiny_real.load_tiny_stt(device='cpu')\n"
        "if tiny_real.have_tiny_tts(): tiny_real.load_tiny_tts(device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'infernos_tpu', 'speechlang'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_native_engine_builds_only_under_the_port():
    """The port's loader compiles its own copy of the engine source into
    ``infernos_tpu_torch/build/`` through a temporary name and never names
    the reference's ``native/`` directory or its build script."""
    from infernos_tpu_torch.media import native

    assert Path(native.SRC) == PKG / "csrc" / "rtp_engine.cpp"
    assert Path(native.LIB) == PKG / "build" / "librtpengine.so"
    src = inspect.getsource(native)
    assert "native/" not in src.replace("csrc/", "") and "from build" not in src
    build_src = inspect.getsource(native.build)
    assert ".tmp" in build_src and "os.replace(tmp, LIB)" in build_src
    assert '"-o", tmp' in build_src


def test_native_engine_source_is_the_reference_engine():
    """The port's copy of the engine source differs from the reference's
    ``native/rtp_engine.cpp`` in whole-line comments only (the paths they
    name), so the two cannot drift apart unseen."""
    from infernos_tpu_torch.media import native

    def body(path):
        return [ln for ln in Path(path).read_text().splitlines()
                if not ln.lstrip().startswith("//")]

    port, ref = body(native.SRC), body(ROOT / "native" / "rtp_engine.cpp")
    assert len(port) > 500 and port == ref


def test_cuda_tts_engine_refuses_more_slots_than_the_kernel_takes():
    """The kernel takes any slot count in groups of at most ``MAX_B``, so
    the only count a CUDA engine refuses is none; 33 and 48 slots, once
    refused, are taken (one launch per group)."""
    from infernos_tpu_torch.serving import tts_engine as tts

    with pytest.raises(ValueError, match="1 slot or more"):
        tts.check_slots(0, torch.device("cuda"))
    for slots in (1, 8, ts.MAX_B, ts.MAX_B + 1, 40, 48):
        tts.check_slots(slots, torch.device("cuda"))
    assert [ts.launches_per_step(b) for b in (1, ts.MAX_B, ts.MAX_B + 1, 40, 48, 65)] == \
        [1, 1, 2, 2, 2, 3]
    for slots in (ts.MAX_B + 1, 48):  # the plain CPU path takes any width
        tts.check_slots(slots, torch.device("cpu"))
    # the constructor checks before it packs a weight or makes any state
    init = inspect.getsource(tts.TTSEngine.__init__)
    assert init.index("check_slots(ecfg.batch_slots, self.device)") < \
        init.index("pack_fused_weights")


def test_cpu_tts_engine_takes_33_slots():
    from infernos_tpu_torch.models import hifigan as hfg
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.serving import tts_engine as tts

    g = torch.Generator().manual_seed(0)
    cfg = st5.SpeechT5Config(vocab_size=16, hidden_size=16, encoder_layers=1,
                             encoder_attention_heads=1, encoder_ffn_dim=16,
                             decoder_layers=1, decoder_attention_heads=1,
                             decoder_ffn_dim=16, num_mel_bins=4,
                             speech_decoder_prenet_units=8,
                             speech_decoder_postnet_units=8,
                             speaker_embedding_dim=4, max_text_positions=8,
                             max_speech_positions=16)
    vcfg = hfg.HifiGanConfig(model_in_dim=4, upsample_initial_channel=8)
    eng = tts.TTSEngine(st5.init_params(cfg, g, "cpu"), cfg,
                        hfg.init_params(vcfg, g, "cpu"), vcfg,
                        tts.TTSEngineConfig(batch_slots=ts.MAX_B + 1,
                                            max_text_tokens=4, max_steps=4),
                        device="cpu")
    assert len(eng.sessions) == ts.MAX_B + 1


@pytest.mark.parametrize("what", ["tiny_stt", "tiny_tts", "griffinlim", "ingest"])
def test_new_entry_points_demand_a_card_unless_cpu_is_asked(monkeypatch, what):
    from infernos_tpu_torch.audio import griffinlim as gl
    from infernos_tpu_torch.media import ingest
    from infernos_tpu_torch.models import tiny_real

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"tiny_stt": lambda **kw: tiny_real.load_tiny_stt(**kw)[3].dtype,
            "tiny_tts": lambda **kw: tiny_real.load_tiny_tts(**kw)[2]["win"].device,
            "griffinlim": lambda **kw: gl.init_params(gl.GriffinLimConfig(), **kw)["win"].device,
            "ingest": lambda **kw: ingest.default_vad_factory(2, **kw).device}[what]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    got = make(device="cpu")
    assert got in (torch.device("cpu"), torch.float32)


def test_daemon_cluster_loads_no_jax_or_reference(tmp_path):
    """``import infernos_tpu_torch.main`` and a whole LiveTranslator
    cluster built and stopped on the CPU (tiny random models, SIP bound on
    port 25094, used by no other test file) leave no ``jax`` or reference module loaded."""
    cfg = tmp_path / "lt.yaml"
    cfg.write_text("sip:\n  settings:\n    bind: 127.0.0.1:25094\n  profiles:\n"
                   "    inbound:\n      sink: apps/live_translator/c1\n"
                   "rtp:\n  settings:\n    min_port: 35900\n    max_port: 35990\n"
                   "apps:\n  live_translator:\n    profiles:\n      c1:\n"
                   "        stt_langs: ['en', 'pt']\n        tts_langs: ['pt', 'en']\n")
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import infernos_tpu_torch.main as m\n"
        "from infernos_tpu_torch.cluster.actors import stop_all\n"
        "from infernos_tpu_torch.config import InfernConfig\n"
        f"h = m.build_cluster(InfernConfig({str(cfg)!r}), tiny=True, device='cpu')\n"
        "assert h['sip'].ask_sync('ready_check')[1] > 0\n"
        "stop_all()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'infernos_tpu'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=240).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_attendant_cluster_loads_no_jax_or_reference(tmp_path):
    """An AI attendant cluster (STT, TTS and LLM actors; tiny random models,
    SIP bound on port 25095, RTP 38500-38590, used by no other test file)
    built and stopped on the CPU in a fresh interpreter leaves no ``jax`` or
    reference module loaded."""
    cfg = tmp_path / "aia.yaml"
    cfg.write_text("sip:\n  settings:\n    bind: 127.0.0.1:25095\n  profiles:\n"
                   "    inbound:\n      sink: apps/ai_attendant/a1\n"
                   "rtp:\n  settings:\n    min_port: 38500\n    max_port: 38590\n"
                   "apps:\n  ai_attendant:\n    profiles:\n      a1:\n"
                   "        stt_lang: en\n        tts_lang: en\n")
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import infernos_tpu_torch.main as m\n"
        "from infernos_tpu_torch.cluster.actors import lookup, stop_all\n"
        "from infernos_tpu_torch.config import InfernConfig\n"
        f"h = m.build_cluster(InfernConfig({str(cfg)!r}), tiny=True, device='cpu')\n"
        "assert h['sip'].ask_sync('ready_check')[1] > 0\n"
        "assert lookup('llm:a1')._actor.engine.device == torch.device('cpu')\n"
        "stop_all()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'infernos_tpu'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=240).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("what", ["engine", "actor", "tiny_llm"])
def test_llm_entry_points_demand_a_card_unless_cpu_is_asked(monkeypatch, what):
    from infernos_tpu_torch.cluster import model_actors as ma
    from infernos_tpu_torch.models import presets, qwen, tiny_real
    from infernos_tpu_torch.serving import llm_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("INFERNOS_MODEL_MODE", raising=False)
    cfg = presets.QWEN_TINY
    params = qwen.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ecfg = llm_engine.LLMEngineConfig(batch_slots=1, prompt_buckets=(8,),
                                      max_total_tokens=16, max_new_tokens=4)

    def start_actor(**kw):
        actor = ma.LLMActor(tiny=True, **kw)
        try:
            actor.start()
            return actor.engine.device
        finally:
            actor.on_stop()

    make = {"engine": lambda **kw: llm_engine.LLMEngine(params, cfg, ecfg, **kw).device,
            "actor": start_actor,
            "tiny_llm": lambda **kw: tiny_real.load_tiny_llm(**kw)[0]["embed"]["w"].device}[what]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert make(device="cpu") == torch.device("cpu")


def test_build_cluster_demands_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    from infernos_tpu_torch import main as pmain
    from infernos_tpu_torch.cluster import actors
    from infernos_tpu_torch.config import InfernConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "lt.yaml"
    cfg.write_text("apps:\n  live_translator:\n    profiles:\n      c1:\n"
                   "        stt_langs: ['en', 'pt']\n        tts_langs: ['pt', 'en']\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmain.build_cluster(InfernConfig(str(cfg)), tiny=True)
    assert actors.lookup("rtp") is None and actors.lookup("sip") is None


TOOL_MODULES = ("tools", "speechlang", "synth_speech", "train_tiny_llm")


def test_benches_load_no_jax_reference_or_tools():
    """Importing the benches and making what they speak and score (the LT
    bench's utterances and frames, loopback's prompts) in a fresh
    interpreter loads no ``jax``, reference or ``tools`` module."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "import infernos_tpu_torch.bench.__main__, infernos_tpu_torch.bench.ttsmain\n"
        "from infernos_tpu_torch.audio.codecs import G711Codec\n"
        "from infernos_tpu_torch.bench import loopback, ltbench, paced_calls\n"
        "rng = np.random.default_rng(0)\n"
        "assert ltbench._encode_frames(G711Codec(), ltbench._utterance(rng, 1.6))\n"
        "assert ltbench.speechlang_utterance(rng).size > 0\n"
        "assert len(loopback.loopback_prompts(2)) == 2\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" ('jax', 'jaxlib', 'infernos_tpu') + {TOOL_MODULES!r})\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted((PKG / "bench").glob("*.py")) + [
    PKG / "audio" / "speechlang.py", PKG / "audio" / "synth_speech.py"],
    ids=lambda p: p.name)
def test_benches_reach_no_tools_and_fall_back_to_nothing(path):
    """No bench source puts ``tools/`` on the path or imports from it, and
    none keeps the reference's tone fallback or its figures from other
    hardware."""
    src = path.read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in TOOL_MODULES for n in names), (path, names)
    assert "sys.path" not in src
    for word in ("last_recorded_hardware", "vs_baseline", "v5e", "/ 50.0"):
        assert word not in src, (path, word)


def test_new_benches_and_ladder_load_no_jax_reference_or_tools():
    """The engine and attendant benches, the sampler and the STT ladder,
    imported in a fresh interpreter with their inputs made (the STT
    corpus, a beam search on a tiny random Whisper), load no ``jax``,
    reference or ``tools`` module."""
    code = (
        "import json, sys\n"
        "import torch\n"
        "from infernos_tpu_torch.bench import aiabench, echo, llmbench, sttbench, ttsbench, ttsprobe\n"
        "from infernos_tpu_torch.utils import pysampler\n"
        "from infernos_tpu_torch.models import presets, whisper as wsp\n"
        "from infernos_tpu_torch.models.whisper_tokens import SPECIALS_V3, build_prompt\n"
        "from infernos_tpu_torch.serving.stt_engine import STTEngineConfig\n"
        "assert len(sttbench.make_g711_corpus(n=2)) == 2\n"
        "assert build_prompt(SPECIALS_V3, 'en')[0]\n"
        "assert STTEngineConfig.for_specials(SPECIALS_V3).sot_prev == 50362\n"
        "cfg = presets.WHISPER_TINY_TEST\n"
        "p = wsp.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "enc = torch.zeros((1, 10, cfg.d_model))\n"
        "wsp.beam_decode(p, cfg, enc, [cfg.sot_token_id, 10], 2, beam_size=2, max_new=3,"
        " eos_id=cfg.eos_token_id)\n"
        "pysampler.Sampler().report()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" ('jax', 'jaxlib', 'infernos_tpu') + {TOOL_MODULES!r})\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def _new_bench_mains():
    from infernos_tpu_torch.bench import aiabench, echo, llmbench, sttbench, ttsbench, ttsprobe

    return {"sttbench": (sttbench, "build_engine", lambda: sttbench.main(["--full"])),
            "ttsbench": (ttsbench, "run_bench", lambda: ttsbench.main(["4", "--full"])),
            "ttsprobe": (ttsprobe, "run_mode", lambda: ttsprobe.main([])),
            "llmbench": (llmbench, "zeros_init", lambda: llmbench.main(["--dims", "tiny"])),
            "aiabench": (aiabench, "build_cluster", lambda: aiabench.main(["--tiny-real"])),
            "echo": (echo, "run_echo", lambda: echo.main(["--tiny-real"]))}


@pytest.mark.parametrize("what", sorted(_new_bench_mains()))
def test_new_bench_mains_demand_a_card_unless_cpu_is_asked(monkeypatch, what):
    """Without a card each new bench's ``main`` raises before it builds an
    engine, a model or a cluster; with ``INFERNOS_DEVICE=cpu`` it goes on,
    on the CPU (a stub in place of its first step stops it there)."""
    module, first_step, run = _new_bench_mains()[what]
    got = []

    def stub(*a, **kw):
        got.append([x for x in list(a) + list(kw.values()) if isinstance(x, torch.device)])
        raise _PastTheDevice

    monkeypatch.setattr(module, first_step, stub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    monkeypatch.setenv("INFERNOS_MODEL_MODE", "")  # --tiny-real sets it
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    assert got == []
    monkeypatch.setenv("INFERNOS_DEVICE", "cpu")
    with pytest.raises(_PastTheDevice):
        run()
    assert got == [[torch.device("cpu")]]


@pytest.mark.parametrize("what,argv", [("sttbench", []), ("ttsbench", ["4"])])
def test_engine_benches_refuse_the_tiny_dims_on_a_card(monkeypatch, what, argv):
    module, first_step, _ = _new_bench_mains()[what]

    def stub(*a, **kw):
        raise _PastTheDevice

    monkeypatch.setattr(module, first_step, stub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    with pytest.raises(SystemExit) as e:
        module.main(argv)
    assert e.value.code == 2
    with pytest.raises(_PastTheDevice):
        module.main(argv + ["--full"])


def _bench_mains():
    from infernos_tpu_torch.bench import loopback, ltbench, ttsmain

    return {"ttsmain": (ttsmain, "build_engine", lambda: ttsmain.main()),
            "ltbench": (ltbench, "MultiFarEnd", lambda: ltbench.main(["--full", "--ramp"])),
            "loopback": (loopback, "tiny_real_engines", lambda: loopback.main([]))}


class _PastTheDevice(Exception):
    """Raised by a stub that a bench's main reaches once it has a device."""


@pytest.mark.parametrize("what", ["ttsmain", "ltbench", "loopback"])
def test_bench_mains_demand_a_card_unless_cpu_is_asked(monkeypatch, what):
    """Without a card each bench's ``main`` raises before it builds an
    engine or binds a socket; with ``INFERNOS_DEVICE=cpu`` it goes on, on
    the CPU (a stub in place of its first step stops it there)."""
    module, first_step, run = _bench_mains()[what]
    got = []

    def stub(*a, **kw):
        got.append([x for x in list(a) + list(kw.values()) if isinstance(x, torch.device)])
        raise _PastTheDevice

    monkeypatch.setattr(module, first_step, stub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    assert got == []
    monkeypatch.setenv("INFERNOS_DEVICE", "cpu")
    with pytest.raises(_PastTheDevice):
        run()
    assert got in ([[torch.device("cpu")]], [[]])  # the LT bench's far end takes a port


def test_ltbench_refuses_the_tiny_random_models_on_a_card(monkeypatch):
    """On a card the LT bench serves ``--full`` or ``--tiny-real``: the
    bare tiny mode exits with a usage error before the far end binds or an
    actor starts."""
    from infernos_tpu_torch.bench import ltbench
    from infernos_tpu_torch.cluster import actors

    def far_end(*a, **kw):
        raise _PastTheDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    # --tiny-real sets it for the actors; the test's undo removes it again
    monkeypatch.setenv("INFERNOS_MODEL_MODE", "")
    monkeypatch.setattr(ltbench, "MultiFarEnd", far_end)
    for argv in ([], ["--ramp"], ["--calls", "2", "--turns", "1"]):
        with pytest.raises(SystemExit) as e:
            ltbench.main(argv)
        assert e.value.code == 2
    assert actors.lookup("rtp") is None and actors.lookup("sip") is None
    for argv in (["--full"], ["--tiny-real"], ["--ramp", "--full"]):
        with pytest.raises(_PastTheDevice):
            ltbench.main(argv)


def test_flagship_demands_a_card_unless_cpu_is_asked():
    """``python -m infernos_tpu_torch.bench`` without a card exits non-zero
    before it starts a bench or prints a result line."""
    env = {k: v for k, v in __import__("os").environ.items() if k != "INFERNOS_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "infernos_tpu_torch.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "{" not in proc.stdout


def _import_roots(src: str):
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." if node.level else (node.module or "").split(".")[0]


def test_remote_plane_and_its_peers_import_no_jax_reference_or_transformers():
    """``cluster/remote.py`` imports the standard library, ``torch`` and the
    port only; the peer sources of ``chip_smoke.py`` (``PEER_SRC``) and of
    the remote tests import no ``jax``, reference or ``transformers``
    module, and neither do the modules their peers import actors from."""
    import chip_smoke as cs
    import test_torch_remote

    roots = set(_import_roots((PKG / "cluster" / "remote.py").read_text()))
    assert roots <= set(sys.stdlib_module_names) | {"torch", "."}, roots
    banned = {"jax", "jaxlib", "infernos_tpu", "transformers"}
    for src in (cs.PEER_SRC, test_torch_remote.CHILD_SRC,
                Path(test_torch_remote.__file__).read_text()):
        roots = set(_import_roots(src))
        assert roots & banned == set(), roots
        assert "infernos_tpu_torch" in roots


REMOTE_BOUNDARY_PORTS = {"sip": 25099, "bob": 25084, "rtp": (40960, 40998)}


@pytest.fixture(scope="module")
def cpu_peer():
    """A peer of ``chip_smoke.Peer`` on this host, which has no card."""
    import chip_smoke as cs

    peer = cs.Peer({"OMP_NUM_THREADS": "1"}, heartbeat_s=0)
    assert not peer.info["cuda"]
    yield peer
    peer.close()


@pytest.mark.parametrize("cls", ["STTActor", "TTSActor", "LLMActor"])
def test_peer_without_a_card_refuses_model_actors_unless_cpu_is_asked(cpu_peer, cls):
    """A model actor spawned in a peer without a card and started with no
    ``device`` raises there, and the asker's ``ask_sync("start")`` raises
    the ``default_device`` error, relayed: the peer never serves on the CPU
    unless ``device="cpu"`` is asked."""
    path = f"infernos_tpu_torch.cluster.model_actors:{cls}"
    h = cpu_peer.conn.spawn_remote(path, True, name=f"nocard:{cls}", timeout=60.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h.ask_sync("start", timeout=120.0)
    assert cpu_peer.probe.ask_sync("modules") == []
    h.stop()


def test_remote_peer_serving_a_tiny_lt_call_loads_no_jax_or_reference(cpu_peer, tmp_path):
    """A LiveTranslator cluster on the CPU here (tiny random models, SIP
    25099 and 25084, RTP 40960-40998, used by no other test file) whose STT
    actor lives in the peer, started there with ``device="cpu"``: a call
    from a ``FakePhone`` reaches the peer's STT, and the peer has loaded no
    ``jax``, reference or ``transformers`` module."""
    import time

    from infernos_tpu_torch.bench.phone import FakePhone, FarEnd
    from infernos_tpu_torch.cluster.actors import stop_all
    from infernos_tpu_torch.config import InfernConfig
    from infernos_tpu_torch.main import build_cluster

    import chip_smoke as cs
    from test_torch_e2e_calls import _speechy

    ports = REMOTE_BOUNDARY_PORTS
    stt = cpu_peer.conn.spawn_remote("infernos_tpu_torch.cluster.model_actors:STTActor",
                                     True, name="stt:lt-boundary", device="cpu",
                                     timeout=60.0)
    stt.ask_sync("start", timeout=600.0)
    cfg = tmp_path / "lt.yaml"
    cfg.write_text(cs.lt_config(ports["sip"], ports["bob"], ports["rtp"]))
    bob, alice = FarEnd(port=ports["bob"]), None
    try:
        iconf = InfernConfig(str(cfg))
        build_cluster(iconf, tiny=True, bind_ip="127.0.0.1", stt_actr=stt, device="cpu")
        alice = FakePhone()
        alice.call(iconf.sip_conf.bind)
        assert alice.uac.connected and bob.answered.wait(60.0)
        alice.stream_bg(_speechy(1.2, seed=7), then_silence=True)
        deadline = time.monotonic() + 240.0
        while (cpu_peer.probe.ask_sync("registry").get("infernos_stt_audio_s_count", 0) < 1
               and time.monotonic() < deadline):
            time.sleep(0.2)
        alice.stop_streaming()
        assert cpu_peer.probe.ask_sync("encodes", "stt:lt-boundary") >= 1
        alice.hangup()
    finally:
        if alice:
            alice.close()
        bob.close()
        stop_all()
        stt.stop()
    assert cpu_peer.probe.ask_sync("modules") == []


def test_parallel_plane_imports_no_jax_or_reference():
    banned = {"jax", "jaxlib", "infernos_tpu", "transformers"}
    for path in sorted((PKG / "parallel").glob("*.py")) + [ROOT / "tests" / "torch_rank_fns.py"]:
        roots = set(_import_roots(path.read_text()))
        assert roots <= set(sys.stdlib_module_names) | {"torch", "numpy", ".",
                                                        "infernos_tpu_torch"}, (path, roots)
        assert not roots & banned, (path, roots)


def test_cpu_rank_process_loads_no_jax_or_reference():
    import torch_rank_fns as rf
    from infernos_tpu_torch.parallel.ranks import run_ranks

    assert run_ranks(rf.loaded_modules, 2, device="cpu") == [[], []]


@pytest.mark.parametrize("what", ["make_mesh", "run_ranks", "dryrun", "entry", "main"])
def test_parallel_entry_points_demand_a_card_unless_cpu_is_asked(monkeypatch, what):
    from infernos_tpu_torch.parallel import dryrun, make_mesh
    from infernos_tpu_torch.parallel.ranks import run_ranks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"make_mesh": lambda **kw: make_mesh(1, **kw).device,
            "run_ranks": lambda **kw: run_ranks(sys.getrecursionlimit, 1, **kw),
            "dryrun": lambda **kw: dryrun.dryrun_multichip(2, **kw),
            "entry": lambda **kw: dryrun.entry(**kw)[1][0]["feat_out"]["w"].device,
            "main": lambda **kw: dryrun.main(["--ranks", "1"])}[what]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    if what in ("make_mesh", "entry"):
        assert make(device="cpu") == torch.device("cpu")


TRAINERS = ("train_tiny_stt", "train_tiny_tts", "train_tiny_llm", "train_vad",
            "train_amendnet", "check_bilingual")


def test_trainers_load_no_jax_reference_or_tools():
    """The trainers, their optimiser and the gate, imported in a fresh
    interpreter with a batch of each made, load no ``jax``, reference or
    ``tools`` module."""
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        + "".join(f"import infernos_tpu_torch.tools.{m}\n" for m in TRAINERS) +
        "from infernos_tpu_torch.tools import (train_amendnet, train_tiny_llm,"
        " train_tiny_stt, train_tiny_tts, train_vad)\n"
        "from infernos_tpu_torch.models import amendnet, vad\n"
        "rng = np.random.default_rng(0)\n"
        "tok = train_tiny_stt.build_tokenizer()\n"
        "assert train_tiny_stt.make_batch(rng, tok, 1)[0].shape == (1, 80, 500)\n"
        "ttok = train_tiny_tts.build_tokenizer()\n"
        "ex = [train_tiny_tts.make_example(rng, ttok, train_tiny_tts.speaker_bank())]\n"
        "assert train_tiny_tts.assemble(ex)[3].shape == (1, 320, 80)\n"
        "from infernos_tpu_torch.models.tokenizers import ByteTokenizer\n"
        "assert train_tiny_llm.make_batch(rng, ByteTokenizer(), 2)[0].shape == (2, 384)\n"
        "assert train_vad.make_batch(rng, 1, 2, vad.VADConfig().window)[0].shape == (1, 2, 768)\n"
        "assert train_amendnet.make_batch(rng, 1, amendnet.AmendNetConfig())[2].shape[0] == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" ('jax', 'jaxlib', 'infernos_tpu', 'optax') + {TOOL_MODULES!r})\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=240).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_sources_reach_no_tools_or_optax(name):
    src = (PKG / "tools" / f"{name}.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in TOOL_MODULES + ("optax",) for n in names), names
    assert "sys.path" not in src


@pytest.mark.parametrize("name", TRAINERS)
def test_trainers_demand_a_card_unless_cpu_is_asked(monkeypatch, tmp_path, name):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"infernos_tpu_torch.tools.{name}")
    argv = [] if name == "check_bilingual" else ["--out", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert list(tmp_path.iterdir()) == []  # refused before anything was written


@pytest.mark.parametrize("name", TRAINERS[:-1])
def test_trainers_never_write_under_the_reference_package(tmp_path, name):
    """By default they write under the port's git-ignored ``build/``; an
    ``--out`` inside ``infernos_tpu/`` is refused before any work."""
    import importlib

    mod = importlib.import_module(f"infernos_tpu_torch.tools.{name}")
    src = (PKG / "tools" / f"{name}.py").read_text()
    assert "optim.default_out(" in src and "infernos_tpu\"" not in src
    for bad in ("infernos_tpu", "infernos_tpu/models/data", "infernos_tpu/../infernos_tpu"):
        with pytest.raises(ValueError, match="JAX package"):
            mod.main(["--out", str(ROOT / bad), "--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("what", ["port_stt", "port_tts", "port_llm", "llm_test", "tts_stream"])
def test_porter_and_examples_demand_a_card_unless_cpu_is_asked(monkeypatch, tmp_path, what):
    """The porter's model modes and the examples run on the card unless
    ``INFERNOS_DEVICE=cpu`` asks for the CPU, and read nothing before that
    (the hub cache here is empty)."""
    from infernos_tpu_torch.examples import llm_test, tts_stream
    from infernos_tpu_torch.tools import port_checkpoints as pc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "cache"))
    out = tmp_path / "out"
    run = {"llm_test": lambda: llm_test.main(1, 1),
           "tts_stream": lambda: tts_stream.main(["hi", "--out", str(out)]),
           }.get(what, lambda: pc.main(["--" + what[5:], "--out", str(out)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    assert not out.exists() or list(out.iterdir()) == []
