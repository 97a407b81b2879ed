"""Single-device compile check and multi-device dry run, over rank processes.

Port of the repository root's ``__graft_entry__.py``.

- :func:`entry` returns ``(fn, example_args)``: one slot-batched TTS decode
  chunk plus the postnet (the heart of the serving plane), through the
  decoder-step kernel on the card and its plain version on the CPU.
- :func:`dryrun_multichip` runs, on ``n`` rank processes
  (``parallel/ranks.py``), the reference's three parts: a TTS engine per
  rank over its block of the slots (``dp``), an ``LLMEngine`` under ``tp``
  on the reference's Qwen config (prefill, joins, decode, sentence
  streaming, the KV cache sharded over its heads) and an STT engine per
  rank over its block of the slots.  The caller gathers what every rank
  returned and makes the reference body's checks: every session emits
  audio, a sentence is finished, the cache holds ``num_kv_heads/n`` heads
  per rank, ``n`` transcripts come back.

The reference re-executes its dry run on a virtual CPU mesh when the backend
has too few devices; this one runs where the caller says.  Without
``device="cpu"`` and without a card it raises; with one card and ``n > 1``
ranks the ranks share the card over gloo, and it says so.

The kernels take head dim 64 only, so on the card the TTS and STT widths
are the reference dry run's head counts times 64 (TTS hidden 256, FFN 512;
Whisper width 128, FFN 256); on the CPU they are the reference's own dims
(head dim 16).  fp32 on every device, as the reference's dry run: on the
card the kernels' fp32 modes.

    python -m infernos_tpu_torch.parallel.dryrun --ranks 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import launch_counts, reset_launch_counts
from ..utils.platform import DeviceLike, default_device


def tiny_cfgs(kernel_dims: bool):
    """The reference dry run's SpeechT5 and HiFi-GAN configs; with
    ``kernel_dims`` widened to head dim 64 (the kernels' only one)."""
    from ..models import hifigan as hfg
    from ..models import speecht5 as st5

    hd = 64 if kernel_dims else 16
    cfg = st5.SpeechT5Config(
        vocab_size=64, hidden_size=4 * hd, encoder_layers=2,
        encoder_attention_heads=4, encoder_ffn_dim=8 * hd, decoder_layers=2,
        decoder_attention_heads=4, decoder_ffn_dim=8 * hd, num_mel_bins=20,
        speech_decoder_prenet_units=32, speech_decoder_prenet_layers=2,
        speech_decoder_postnet_units=32, speech_decoder_postnet_layers=2,
        reduction_factor=2, speaker_embedding_dim=16, max_text_positions=64,
        max_speech_positions=512, encoder_max_relative_position=16,
    )
    voc = hfg.HifiGanConfig(
        model_in_dim=20, upsample_initial_channel=32, upsample_rates=(4, 4),
        upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),),
    )
    return cfg, voc


def whisper_cfg(kernel_dims: bool):
    """The reference dry run's Whisper config (widened as :func:`tiny_cfgs`)."""
    from ..models import whisper as wsp

    hd = 64 if kernel_dims else 16
    return wsp.WhisperConfig(
        vocab_size=96, num_mel_bins=20, d_model=2 * hd, encoder_layers=1,
        encoder_attention_heads=2, decoder_layers=1,
        decoder_attention_heads=2, ffn_dim=4 * hd, max_source_positions=100,
        max_target_positions=48, eos_token_id=2, sot_token_id=3,
        no_speech_token_id=4)


def qwen_cfg(n: int):
    """The reference dry run's Qwen config for ``n`` ranks: ``n`` heads
    and ``n`` KV heads, one of each per rank."""
    from ..models import qwen

    return qwen.QwenConfig(
        vocab_size=128, hidden_size=8 * n, num_layers=2,
        num_heads=n, num_kv_heads=n, head_dim=8,
        intermediate_size=16 * n, rope_theta=10000.0,
        max_positions=64, eos_token_id=2, tie_word_embeddings=False,
    )


def entry(device: DeviceLike = None):
    """``(fn, example_args)``: ``fn(*example_args)`` decodes one chunk of
    8 mel frames for 4 slots (prenet with its dropout drawn from the
    generator argument, decoder step, feature head) and returns the
    postnet's ``[4, 8, n_mels]``."""
    from ..models import speecht5 as st5
    from ..ops.tts_step import fused_decode_step, pack_fused_weights

    dev = default_device(device)
    cfg, _ = tiny_cfgs(dev.type == "cuda")
    B, S, C = 4, 16, 8
    g = torch.Generator(device=dev).manual_seed(0)
    params = st5.init_params(cfg, g, dev)
    cache = st5.init_cache(cfg, B, 64, S, dev)
    enc = torch.randn((B, S, cfg.hidden_size), generator=g, device=dev)
    cache = st5.fill_cross_kv(params, cfg, cache, enc)

    def forward(params, cache, prev_mel, spk, pos, generator):
        packed = pack_fused_weights(params, cfg)
        mels = []
        for _ in range(C // cfg.reduction_factor):
            x = st5.decoder_prenet(params, cfg, prev_mel, spk, step_offset=pos,
                                   generator=generator)
            h = fused_decode_step(params, cfg, x, cache, pos, packed=packed)
            mel, _ = st5.feat_and_prob(params, cfg, h)
            prev_mel, pos = mel[:, -1:, :], pos + 1
            mels.append(mel)
        mels = torch.stack(mels, 1).reshape(B, C, cfg.num_mel_bins)
        return st5.postnet(params, cfg, mels)

    example_args = (
        params,
        cache,
        torch.zeros((B, 1, cfg.num_mel_bins), device=dev),
        torch.randn((B, cfg.speaker_embedding_dim), generator=g, device=dev),
        torch.zeros(B, dtype=torch.long, device=dev),
        torch.Generator(device=dev).manual_seed(3),
    )
    return forward, example_args




def _tts_part(mesh, kernel: bool) -> List:
    from ..models import hifigan as hfg
    from ..models import speecht5 as st5
    from ..serving.tts_engine import TTSEngine, TTSEngineConfig
    from .mesh import block, replicate

    n, r = mesh.size, mesh.rank
    cfg, voc = tiny_cfgs(kernel)
    g = torch.Generator(device=mesh.device).manual_seed(0)
    params = replicate(st5.init_params(cfg, g, mesh.device), mesh)
    voc_params = replicate(hfg.init_params(voc, g, mesh.device), mesh)
    lo, hi = block(n, n, r)  # one global slot per rank, as the reference
    ecfg = TTSEngineConfig(batch_slots=hi - lo, max_text_tokens=16, max_steps=32,
                           pre_frames=4, chunk_schedule=(8,), min_steps=2)
    eng = TTSEngine(params, cfg, voc_params, voc, ecfg, device=mesh.device)
    got = []
    rng = np.random.default_rng(0)
    for i in range(n):
        spk = rng.standard_normal(cfg.speaker_embedding_dim).astype(np.float32)
        if lo <= i < hi:  # the sessions whose global slot is this rank's
            eng.start_session(np.arange(2, 6, dtype=np.int32), spk,
                              lambda a, i=i: got.append((i, None if a is None else len(a))),
                              max_frames=8)
    eng.step()
    eng.step()  # one-tick pipeline: the second step harvests the first tick
    return got


def _llm_part(mesh_device: DeviceLike) -> Dict[str, Any]:
    from ..models import qwen
    from ..serving.llm_engine import LLMEngine, LLMEngineConfig, LLMRequest
    from .mesh import make_mesh, replicate, shard

    tp = make_mesh(axes=("tp",), device=mesh_device)
    qcfg = qwen_cfg(tp.size)
    g = torch.Generator(device=tp.device).manual_seed(3)
    full = replicate(qwen.init_params(qcfg, g, tp.device), tp)
    eng = LLMEngine(shard(full, qwen.param_shardings(qcfg), tp), qcfg,
                    LLMEngineConfig(batch_slots=2, prompt_buckets=(16,),
                                    max_total_tokens=32, max_new_tokens=6),
                    mesh=tp)
    outs = []
    for i in range(2):
        eng.submit(LLMRequest(np.arange(3 + i, 11 + i, dtype=np.int64),
                              lambda s, fin: outs.append((s, fin))))
    while eng.step():
        pass
    return {"outs": outs, "cache": tuple(eng.cache.k.shape),
            "kv_heads": qcfg.num_kv_heads}


def _stt_part(mesh, kernel: bool) -> List:
    from ..models import whisper as wsp
    from ..serving.stt_engine import STTEngine, STTEngineConfig, STTRequest
    from .mesh import block, replicate

    n, r = mesh.size, mesh.rank
    wcfg = whisper_cfg(kernel)
    lo, hi = block(n, n, r)
    g = torch.Generator(device=mesh.device).manual_seed(5)
    seng = STTEngine(
        replicate(wsp.init_params(wcfg, g, mesh.device), mesh), wcfg,
        STTEngineConfig(batch_slots=hi - lo, buckets_s=(1,), max_new_tokens=4,
                        max_prompt_tokens=8, lang_tokens={"en": 10},
                        task_transcribe=12, task_translate=13, no_timestamps=14,
                        no_speech=4),
        device=mesh.device)
    sres = []
    rng = np.random.default_rng(1)
    for i in range(n):
        audio = (rng.standard_normal(8000) * 0.05).astype(np.float32)
        if lo <= i < hi:
            seng.submit(STTRequest(audio=audio,
                                   text_cb=lambda res, i=i: sres.append((i, len(res.tokens))),
                                   lang="en"))
    for _ in range(8):
        if not seng.step():
            break
    return sres


def _dryrun_rank(device_type: str) -> Dict[str, Any]:
    """One rank's three parts; what it emitted, its kernels' launches in
    this process and the reference modules it loaded."""
    from .mesh import make_mesh

    dev = "cpu" if device_type == "cpu" else None
    mesh = make_mesh(axes=("dp",), device=dev)
    kernel = mesh.device.type == "cuda"
    reset_launch_counts()
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend,
           "tts": _tts_part(mesh, kernel)}
    tts_launches = launch_counts()
    out["llm"] = _llm_part(dev)
    reset_launch_counts()
    out["stt"] = _stt_part(mesh, kernel)
    out["launches"] = {"tts": tts_launches, "stt": launch_counts()}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "infernos_tpu"))
    return out


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> List[Dict[str, Any]]:
    """The three parts on ``n_devices`` rank processes (see the module
    docstring); returns each rank's results and raises when a check
    fails."""
    from .ranks import run_ranks

    dev = default_device(device)
    if dev.type == "cuda":
        from ..ops import build

        build.build()  # once here, not in every rank at once
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        print(f"dryrun_multichip({n_devices}): {n_devices} ranks share "
              f"{torch.cuda.device_count()} card(s) over gloo", flush=True)
    res = run_ranks(_dryrun_rank, n_devices, (dev.type,), device=dev)
    got = [e for r in res for e in r["tts"]]
    if {i for i, n in got if n} != set(range(n_devices)):
        raise RuntimeError(f"dryrun_multichip: a TTS session emitted no audio: {got}")
    print(f"dryrun_multichip({n_devices}): TTS dp step OK, emitted {got[:4]}...")
    llm = res[0]["llm"]
    if not any(fin for _, fin in llm["outs"]):
        raise RuntimeError(f"dryrun_multichip: no LLM sentence finished: {llm['outs']}")
    if any(r["llm"]["outs"] != llm["outs"] for r in res):
        raise RuntimeError("dryrun_multichip: the tp ranks streamed different sentences")
    want = llm["kv_heads"] // n_devices
    if any(r["llm"]["cache"][2] != want for r in res):
        raise RuntimeError(f"dryrun_multichip: KV cache not sharded over its heads: "
                           f"{[r['llm']['cache'] for r in res]}")
    print(f"dryrun_multichip({n_devices}): LLM tp engine prefill+decode OK "
          f"({len(llm['outs'])} streamed sentences, cache {llm['cache']} per rank: "
          f"{want} of {llm['kv_heads']} KV heads)")
    sres = [e for r in res for e in r["stt"]]
    if len(sres) != n_devices:
        raise RuntimeError(f"dryrun_multichip: {len(sres)} of {n_devices} transcripts")
    print(f"dryrun_multichip({n_devices}): STT dp engine encode+ring-decode OK "
          f"({len(sres)} transcripts, one slot per rank)")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="where the ranks run (default: the card; without one it "
                         "raises)")
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    with torch.no_grad():
        out = fn(*ex)
    print("entry forward:", tuple(out.shape), out.dtype)
    for r in dryrun_multichip(args.ranks, args.device):
        print(f"rank {r['rank']}: {r['device']} over {r['backend']}, kernel launches "
              f"{r['launches']}, reference modules loaded {r['modules']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
