"""Port HF checkpoints into the port's format, or rehearse the port offline.

Port of ``tools/port_checkpoints.py``:

    python -m infernos_tpu_torch.tools.port_checkpoints --out DIR [--tts] [--stt]
           [--llm] [--speakers] [--int8]
    python -m infernos_tpu_torch.tools.port_checkpoints --dry-run [--out DIR]

The model modes port the checkpoints the reference deploys, read from the
local Hugging Face hub cache (``models/hf_snapshot.py``: ``$HF_HUB_CACHE``,
else ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``) with no network
and no ``transformers``:

- ``--tts``: ``microsoft/speecht5_tts`` -> ``DIR/tts_en`` and
  ``microsoft/speecht5_hifigan`` -> ``DIR/hifigan`` (no SpeechT5 tokenizer
  is saved, as in the reference);
- ``--stt``: ``openai/whisper-large-v3`` -> ``DIR/whisper`` and its
  tokenizer files -> ``DIR/whisper/tokenizer``;
- ``--llm``: ``Qwen/Qwen2.5-14B-Instruct`` -> ``DIR/qwen`` and
  ``DIR/qwen/tokenizer``;
- ``--int8``: every model but HiFi-GAN through ``models/quant.py``'s
  ``quantize_params`` before it is saved; otherwise the trees are what
  ``port_from_hf`` gives (fp32).

With no mode flag every mode runs, ``--speakers`` last.  ``--speakers``
reads the CMU-Arctic xvector bank, a Hub dataset, through ``datasets``,
which the port does not use: it exits non-zero after the other modes have
written.  A model missing from the cache exits non-zero naming the path it
looked up.  The reference writes to ``/ckpt`` by default; the model modes
here need ``--out``.

``--dry-run`` needs no network: it writes small checkpoints in the exact
on-disk layout a real port produces (``params.pt`` + ``config.json`` +
tokenizer files: ``vocab.json``/``merges.txt`` for Whisper and Qwen,
``spiece.model`` for SpeechT5), reloads each cold and drives tokenize ->
infer -> detokenize through each model.

Everything runs on the card, or on the CPU when ``INFERNOS_DEVICE=cpu`` is
set; without a card and without it, it raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

CORPUS = ["the quick brown fox jumps over the lazy dog",
          "please transfer my call to the billing department",
          "good morning how can i help you today"] * 10


TTS_CHECKPOINTS = {
    "en": "microsoft/speecht5_tts",
    # the reference's per-language map (Cluster/InfernTTSWorker.py:37-45)
    # adds sobomax/speecht5_tts-* variants; extend as needed
}
HIFIGAN = "microsoft/speecht5_hifigan"
WHISPER = "openai/whisper-large-v3"
QWEN = "Qwen/Qwen2.5-14B-Instruct"


def _device():
    from ..utils.platform import default_device

    return default_device(os.environ.get("INFERNOS_DEVICE") or None)


def _port(name: str, kind: str, mod, device):
    """``mod.port_from_hf`` of cached model ``name``: (params, config,
    snapshot directory)."""
    from ..models import hf_snapshot

    model = hf_snapshot.load(name, kind, device)
    params, cfg = mod.port_from_hf(model)
    return params, cfg, model.snapshot


def _save(path: str, params, cfg, int8: bool) -> None:
    import torch

    from ..models import checkpoint as ckpt
    from ..models import quant

    if int8:
        params = quant.quantize_params(params, consume=True)
    ckpt.save(path, params, cfg)
    del params
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def port_tts(out: str, int8: bool) -> None:
    from ..models import hifigan as hfg
    from ..models import speecht5 as st5

    dev = _device()
    for lang, name in TTS_CHECKPOINTS.items():
        params, cfg, _ = _port(name, "speecht5", st5, dev)
        _save(os.path.join(out, f"tts_{lang}"), params, cfg, int8)
        del params
        print(f"ported {name} -> tts_{lang}")
    vparams, vcfg, _ = _port(HIFIGAN, "hifigan", hfg, dev)
    _save(os.path.join(out, "hifigan"), vparams, vcfg, False)
    print("ported hifigan")


def port_stt(out: str, int8: bool) -> None:
    from ..models import hf_snapshot
    from ..models import whisper as wsp

    params, cfg, snap = _port(WHISPER, "whisper", wsp, _device())
    _save(os.path.join(out, "whisper"), params, cfg, int8)
    del params
    hf_snapshot.copy_tokenizer(snap, os.path.join(out, "whisper", "tokenizer"))
    print(f"ported {WHISPER}")


def port_llm(out: str, int8: bool) -> None:
    from ..models import hf_snapshot
    from ..models import qwen

    params, cfg, snap = _port(QWEN, "qwen", qwen, _device())
    _save(os.path.join(out, "qwen"), params, cfg, int8)
    del params
    hf_snapshot.copy_tokenizer(snap, os.path.join(out, "qwen", "tokenizer"))
    print(f"ported {QWEN}")


def port_speakers(out: str) -> int:
    print("port_checkpoints: --speakers reads the Matthijs/cmu-arctic-xvectors "
          "dataset from the Hub through the datasets package, which this package "
          "does not use; put the bank's xvectors.npz (an 'xvectors' array [N, 512]) "
          f"into {out} by hand", file=sys.stderr)
    return 2


def dry_run(out: str) -> None:
    """Small models and the real tokenizer engines through the whole save ->
    load -> tokenize -> infer -> detokenize path.

    The reference rehearses a Whisper of width 32 with 4 heads (head dim 8)
    in fp32.  The encoder attention kernel takes head dim 64, so this
    Whisper is width 128 with 2 heads; fp32 on every device, as the
    reference rehearses it (its fp32 kernel mode on the card)."""
    import numpy as np
    import torch

    from ..models import checkpoint as ckpt
    from ..models import qwen, speecht5, whisper
    from ..models.bpe import train_bpe
    from ..models.spm import save_spm_model, train_char_spm
    from ..models.tiny_real import serving_dtype
    from ..models.tokenizers import load_tokenizer
    from ..utils.platform import default_device

    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    dtype = serving_dtype(dev, tiny=True)

    def gen():
        return torch.Generator().manual_seed(0)

    # --- STT (Whisper-shaped) ---
    wcfg = whisper.WhisperConfig(
        vocab_size=400, num_mel_bins=16, d_model=128, encoder_layers=2,
        encoder_attention_heads=2, decoder_layers=2,
        decoder_attention_heads=2, ffn_dim=256, max_source_positions=32,
        max_target_positions=32, eos_token_id=399, sot_token_id=398,
        no_speech_token_id=397)
    wdir = os.path.join(out, "whisper")
    ckpt.save(wdir, whisper.init_params(wcfg, gen(), dev, dtype), wcfg)
    tokdir = os.path.join(wdir, "tokenizer")
    os.makedirs(tokdir, exist_ok=True)
    bpe = train_bpe(CORPUS, vocab_size=396)
    bpe.save(os.path.join(tokdir, "vocab.json"), os.path.join(tokdir, "merges.txt"))
    wcfg2 = ckpt.load_config(wdir, whisper.WhisperConfig)
    wparams = ckpt.load(wdir, whisper.init_params(wcfg2, gen(), dev, dtype), dev)
    wtok = load_tokenizer(tokdir)
    mel = torch.zeros((1, wcfg2.num_mel_bins, 64), dtype=dtype, device=dev)
    with torch.no_grad():
        enc = whisper.encode(wparams, wcfg2, mel)
        logits = whisper.decode_full(
            wparams, wcfg2, torch.tensor([[wcfg2.sot_token_id]], device=dev), enc)
    nxt = int(torch.argmax(logits[0, -1]))
    text = wtok.detokenize([t for t in [nxt] if t < 396])
    print(f"dry-run STT: encode{list(enc.shape)} {enc.dtype} -> token {nxt} -> {text!r}")

    # --- TTS (SpeechT5-shaped) ---
    spm = train_char_spm(CORPUS)
    scfg = speecht5.SpeechT5Config(
        vocab_size=spm.vocab_size, hidden_size=32, encoder_layers=2,
        encoder_attention_heads=4, encoder_ffn_dim=64, decoder_layers=2,
        decoder_attention_heads=4, decoder_ffn_dim=64, num_mel_bins=8,
        speech_decoder_prenet_units=16, speech_decoder_postnet_units=16,
        speaker_embedding_dim=8, max_text_positions=64,
        max_speech_positions=64)
    sdir = os.path.join(out, "tts_en")
    ckpt.save(sdir, speecht5.init_params(scfg, gen(), dev, dtype), scfg)
    stokdir = os.path.join(sdir, "tokenizer")
    os.makedirs(stokdir, exist_ok=True)
    save_spm_model(spm, os.path.join(stokdir, "spiece.model"))
    scfg2 = ckpt.load_config(sdir, speecht5.SpeechT5Config)
    sparams = ckpt.load(sdir, speecht5.init_params(scfg2, gen(), dev, dtype), dev)
    stok = load_tokenizer(stokdir)
    ids = stok("hello world")
    with torch.no_grad():
        enc_out = speecht5.encode_text(
            sparams, scfg2, torch.as_tensor(np.asarray(ids), device=dev)[None, :])
    rt = stok.detokenize(ids)
    if rt != "hello world":
        raise RuntimeError(f"dry-run TTS: tokenizer round trip gave {rt!r}")
    print(f"dry-run TTS: {len(ids)} ids -> enc{list(enc_out.shape)} -> {rt!r}")

    # --- LLM (Qwen-shaped) ---
    qtokdir = os.path.join(out, "qwen", "tokenizer")
    os.makedirs(qtokdir, exist_ok=True)
    qbpe = train_bpe(CORPUS, vocab_size=380,
                     special_tokens=["<|im_start|>", "<|im_end|>"])
    qbpe.save(os.path.join(qtokdir, "vocab.json"), os.path.join(qtokdir, "merges.txt"))
    qcfg = qwen.QwenConfig(
        vocab_size=qbpe.vocab_size, hidden_size=32, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=8, intermediate_size=64,
        max_positions=128, eos_token_id=qbpe.special["<|im_end|>"])
    qdir = os.path.join(out, "qwen")
    ckpt.save(qdir, qwen.init_params(qcfg, gen(), dev, dtype), qcfg)
    qcfg2 = ckpt.load_config(qdir, qwen.QwenConfig)
    qparams = ckpt.load(qdir, qwen.init_params(qcfg2, gen(), dev, dtype), dev)
    qtok = load_tokenizer(
        qtokdir, special_tokens={"<|im_start|>": qbpe.special["<|im_start|>"],
                                 "<|im_end|>": qbpe.special["<|im_end|>"]})
    qids = qtok("<|im_start|>how can i help<|im_end|>")
    with torch.no_grad():
        logits = qwen.prefill(qparams, qcfg2,
                              torch.as_tensor(np.asarray(qids), device=dev)[None, :])[0]
    nxt = int(torch.argmax(logits[0, -1]))
    print(f"dry-run LLM: {len(qids)} ids -> next token {nxt} "
          f"-> {qtok.detokenize([nxt])!r}")
    print(f"dry-run OK: save/load/tokenize/infer/detokenize all offline on {dev}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="checkpoint directory (--dry-run: a new temporary "
                         "directory when not given)")
    ap.add_argument("--tts", action="store_true")
    ap.add_argument("--stt", action="store_true")
    ap.add_argument("--llm", action="store_true")
    ap.add_argument("--speakers", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    a = ap.parse_args(argv)
    if a.dry_run:
        out = a.out or tempfile.mkdtemp(prefix="ckpt_dryrun_")
        os.makedirs(out, exist_ok=True)
        dry_run(out)
        return 0
    if a.out is None:
        print("port_checkpoints: the model modes need --out", file=sys.stderr)
        return 2
    if not any((a.tts, a.stt, a.llm, a.speakers)):
        a.tts = a.stt = a.llm = a.speakers = True
    os.makedirs(a.out, exist_ok=True)
    try:
        if a.tts:
            port_tts(a.out, a.int8)
        if a.stt:
            port_stt(a.out, a.int8)
        if a.llm:
            port_llm(a.out, a.int8)
    except FileNotFoundError as e:
        print(f"port_checkpoints: {e}", file=sys.stderr)
        return 1
    return port_speakers(a.out) if a.speakers else 0


if __name__ == "__main__":
    sys.exit(main())
