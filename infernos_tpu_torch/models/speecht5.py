"""SpeechT5-class text-to-speech model in PyTorch: text encoder, slot-batched
autoregressive spectrogram decoder and postnet.

Port of ``infernos_tpu/models/speecht5.py`` (HF ``SpeechT5ForTextToSpeech``
numerics) with the same parameter key paths.  ``decode_step`` here is the
plain decoder step; serving calls
:func:`infernos_tpu_torch.ops.tts_step.fused_decode_step`, whose CUDA kernels
compute the same step.  The prenet's dropout mask comes from an explicit
``torch.Generator`` or is passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import layers as L
from .convert import HFStateDict


@dataclasses.dataclass(frozen=True)
class SpeechT5Config:
    vocab_size: int = 81
    hidden_size: int = 768
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    decoder_layers: int = 6
    decoder_attention_heads: int = 12
    decoder_ffn_dim: int = 3072
    num_mel_bins: int = 80
    reduction_factor: int = 2
    speech_decoder_prenet_layers: int = 2
    speech_decoder_prenet_units: int = 256
    speech_decoder_prenet_dropout: float = 0.5
    speech_decoder_postnet_layers: int = 5
    speech_decoder_postnet_units: int = 256
    speech_decoder_postnet_kernel: int = 5
    speaker_embedding_dim: int = 512
    max_text_positions: int = 450
    max_speech_positions: int = 4000
    encoder_max_relative_position: int = 160
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.encoder_attention_heads


# -- init ---------------------------------------------------------------------

def _mha_init(g, d, dev, dt):
    return {n: L.linear_init(g, d, d, dev, dt) for n in ("q", "k", "v", "o")}


def init_params(cfg: SpeechT5Config, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict[str, Any]:
    """Seeded random parameters (torch.nn default inits) on ``device``."""
    g, D = generator, cfg.hidden_size

    def lin(a, b, bias=True):
        return L.linear_init(g, a, b, device, dtype, bias)

    def ln():
        return L.layer_norm_init(D, device, dtype)

    prenet = [cfg.num_mel_bins] + [cfg.speech_decoder_prenet_units] * \
        cfg.speech_decoder_prenet_layers
    post = ([cfg.num_mel_bins]
            + [cfg.speech_decoder_postnet_units] * (cfg.speech_decoder_postnet_layers - 1)
            + [cfg.num_mel_bins])
    one = torch.ones((), device=device, dtype=dtype)
    return {
        "text_embed": L.embedding_init(g, cfg.vocab_size, D, device, dtype,
                                       cfg.pad_token_id),
        "enc_pos_alpha": one.clone(),
        "enc_rel_pos": L.embedding_init(
            g, 2 * cfg.encoder_max_relative_position, cfg.head_dim, device, dtype),
        "enc_ln": ln(),
        "enc_layers": L.stack_layers([
            {"attn": _mha_init(g, D, device, dtype), "ln1": ln(),
             "ffn": {"in": lin(D, cfg.encoder_ffn_dim),
                     "out": lin(cfg.encoder_ffn_dim, D)},
             "ln2": ln()}
            for _ in range(cfg.encoder_layers)]),
        "dec_prenet": {
            "layers": [lin(prenet[i], prenet[i + 1])
                       for i in range(cfg.speech_decoder_prenet_layers)],
            "final": lin(cfg.speech_decoder_prenet_units, D),
            "pos_alpha": one.clone(),
            "speaker": lin(cfg.speaker_embedding_dim + D, D),
        },
        "dec_layers": L.stack_layers([
            {"self_attn": _mha_init(g, D, device, dtype), "ln1": ln(),
             "cross_attn": _mha_init(g, D, device, dtype), "ln2": ln(),
             "ffn": {"in": lin(D, cfg.decoder_ffn_dim),
                     "out": lin(cfg.decoder_ffn_dim, D)},
             "ln3": ln()}
            for _ in range(cfg.decoder_layers)]),
        "feat_out": lin(D, cfg.num_mel_bins * cfg.reduction_factor),
        "prob_out": lin(D, cfg.reduction_factor),
        "postnet": [
            {"conv": L.conv1d_init(g, post[i], post[i + 1],
                                   cfg.speech_decoder_postnet_kernel, device,
                                   dtype, bias=False),
             "bn": {"g": torch.ones(post[i + 1], device=device, dtype=dtype),
                    "b": torch.zeros(post[i + 1], device=device, dtype=dtype),
                    "running_mean": torch.zeros(post[i + 1], device=device,
                                                dtype=dtype),
                    "running_var": torch.ones(post[i + 1], device=device,
                                              dtype=dtype)}}
            for i in range(cfg.speech_decoder_postnet_layers)],
    }


# -- encoder ------------------------------------------------------------------

def encode_text(params, cfg: SpeechT5Config, input_ids, attention_mask=None):
    """``[B, S]`` ids -> ``[B, S, D]`` encoder states (text prenet, then the
    relative-position-bias transformer encoder)."""
    _, S = input_ids.shape
    dev = input_ids.device
    emb = params["text_embed"]["w"]
    pe = L.sinusoid_interleaved_table(cfg.max_text_positions,
                                      cfg.hidden_size, dev, emb.dtype)
    x = emb[input_ids.long()] + params["enc_pos_alpha"] * pe[:S]
    x = L.layer_norm(x, params["enc_ln"], cfg.layer_norm_eps)
    pos = torch.arange(S, device=dev)
    rel = (pos[:, None] - pos[None, :]).clamp(
        -cfg.encoder_max_relative_position, cfg.encoder_max_relative_position - 1)
    pos_bias = params["enc_rel_pos"]["w"][rel + cfg.encoder_max_relative_position]
    mask_bias = None
    if attention_mask is not None:
        mask_bias = L.pad_mask_to_bias(attention_mask, S)
    eps, H = cfg.layer_norm_eps, cfg.encoder_attention_heads
    for i in range(cfg.encoder_layers):
        lp = L.layer_slice(params["enc_layers"], i)
        h = L.attention(lp["attn"], x, n_heads=H, mask=mask_bias,
                        pos_bias=pos_bias)
        x = L.layer_norm(x + h, lp["ln1"], eps)
        h = L.linear(L.gelu(L.linear(x, lp["ffn"]["in"])), lp["ffn"]["out"])
        x = L.layer_norm(x + h, lp["ln2"], eps)
    return x


# -- decoder prenet -----------------------------------------------------------

def prenet_dropout_masks(cfg: SpeechT5Config, n_frames: int,
                         generator: torch.Generator, device) -> List[torch.Tensor]:
    """One consistent-dropout mask per prenet layer, ``[n_frames, units]``
    bool, shared across the batch: True with probability ``p`` (the
    reference's ``bernoulli(p)`` keep mask)."""
    p = cfg.speech_decoder_prenet_dropout
    shape = (n_frames, cfg.speech_decoder_prenet_units)
    out = []
    for _ in range(cfg.speech_decoder_prenet_layers):
        u = torch.rand(shape, generator=generator, device=generator.device)
        out.append((u < p).to(device))
    return out


def decoder_prenet(params, cfg: SpeechT5Config, mel_in, speaker_emb, *,
                   step_offset, generator: Optional[torch.Generator] = None,
                   dropout_masks: Optional[List[torch.Tensor]] = None):
    """``[B, T, n_mels]`` + ``[B, spk_dim]`` -> ``[B, T, D]`` decoder inputs.

    Consistent dropout: masks from ``dropout_masks`` when given, else drawn
    from ``generator``; neither (or p = 0) disables it.  ``step_offset``
    ``[B]`` is each slot's decoder position.
    """
    p = params["dec_prenet"]
    dp = cfg.speech_decoder_prenet_dropout
    T = mel_in.shape[1]
    if dropout_masks is None and generator is not None and dp > 0:
        dropout_masks = prenet_dropout_masks(cfg, T, generator, mel_in.device)
    x = mel_in
    for i, lp in enumerate(p["layers"]):
        x = torch.relu(L.linear(x, lp))
        if dropout_masks is not None and dp > 0:
            x = torch.where(dropout_masks[i][None], x, 0.0) / (1.0 - dp)
    x = L.linear(x, p["final"])
    pe = L.sinusoid_interleaved_table(cfg.max_speech_positions,
                                      cfg.hidden_size, x.device, x.dtype)
    pos_idx = step_offset.long()[:, None] + torch.arange(T, device=x.device)[None, :]
    x = x + p["pos_alpha"] * pe[pos_idx]
    if speaker_emb is not None:
        spk = speaker_emb / torch.linalg.vector_norm(
            speaker_emb, dim=-1, keepdim=True).clamp_min(1e-12)
        spk = spk[:, None, :].expand(x.shape[0], T, spk.shape[-1])
        x = torch.relu(L.linear(torch.cat([x, spk.to(x.dtype)], dim=-1),
                                p["speaker"]))
    return x


# -- decoder ------------------------------------------------------------------

@dataclasses.dataclass
class DecoderCache:
    """Slot-batched decoder state: self K/V caches + precomputed cross K/V,
    all ``[L, B, H, T, Dh]``."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def init_cache(cfg: SpeechT5Config, batch: int, max_steps: int, enc_len: int,
               device, dtype=torch.float32) -> DecoderCache:
    Lyr, H, Dh = cfg.decoder_layers, cfg.decoder_attention_heads, cfg.head_dim

    def z(t):
        return torch.zeros((Lyr, batch, H, t, Dh), dtype=dtype, device=device)

    return DecoderCache(z(max_steps), z(max_steps), z(enc_len), z(enc_len))


def cross_kv(params, cfg: SpeechT5Config, enc_out):
    """Per-layer cross K/V of ``enc_out``: two ``[L, B, H, S, Dh]`` tensors."""
    ks, vs = [], []
    for i in range(cfg.decoder_layers):
        lp = L.layer_slice(params["dec_layers"], i)
        k, v = L.precompute_cross_kv(lp["cross_attn"], enc_out,
                                     n_heads=cfg.decoder_attention_heads)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def fill_cross_kv(params, cfg: SpeechT5Config, cache: DecoderCache,
                  enc_out) -> DecoderCache:
    ks, vs = cross_kv(params, cfg, enc_out)
    return dataclasses.replace(cache, cross_k=ks.to(cache.cross_k.dtype),
                               cross_v=vs.to(cache.cross_v.dtype))


def decode_full(params, cfg: SpeechT5Config, dec_in, enc_out, enc_mask=None,
                return_cross_attn: bool = False):
    """Teacher-forced decoder over prenet outputs ``[B, T, D]`` -> hidden
    states ``[B, T, D]`` (the reference for the cached steps and the step
    kernel); with ``return_cross_attn`` also the per-layer cross-attention
    weights ``[L, B, H, T, S]``."""
    T = dec_in.shape[1]
    H, eps = cfg.decoder_attention_heads, cfg.layer_norm_eps
    causal = L.causal_bias(T, device=dec_in.device)
    xmask = L.pad_mask_to_bias(enc_mask, T) if enc_mask is not None else None
    x, ws = dec_in, []
    for i in range(cfg.decoder_layers):
        lp = L.layer_slice(params["dec_layers"], i)
        x = L.layer_norm(x + L.attention(lp["self_attn"], x, n_heads=H,
                                         mask=causal), lp["ln1"], eps)
        h, w = L.attention(lp["cross_attn"], x, enc_out, n_heads=H,
                           mask=xmask, return_probs=True)
        ws.append(w)
        x = L.layer_norm(x + h, lp["ln2"], eps)
        h = L.linear(L.gelu(L.linear(x, lp["ffn"]["in"])), lp["ffn"]["out"])
        x = L.layer_norm(x + h, lp["ln3"], eps)
    return (x, torch.stack(ws)) if return_cross_attn else x


def decode_step(params, cfg: SpeechT5Config, x, cache: DecoderCache, pos,
                enc_mask=None):
    """One plain AR decoder step for all slots: x ``[B, 1, D]``, pos ``[B]``.
    Writes the self K/V rows in place; returns ``[B, 1, D]``."""
    H, eps = cfg.decoder_attention_heads, cfg.layer_norm_eps
    for i in range(cfg.decoder_layers):
        lp = L.layer_slice(params["dec_layers"], i)
        h = L.attention_step(lp["self_attn"], x, n_heads=H,
                             k_cache=cache.self_k[i], v_cache=cache.self_v[i],
                             pos=pos)
        x = L.layer_norm(x + h, lp["ln1"], eps)
        h = L.cross_attention_step(lp["cross_attn"], x, cache.cross_k[i],
                                   cache.cross_v[i], n_heads=H,
                                   kv_mask=enc_mask)
        x = L.layer_norm(x + h, lp["ln2"], eps)
        h = L.linear(L.gelu(L.linear(x, lp["ffn"]["in"])), lp["ffn"]["out"])
        x = L.layer_norm(x + h, lp["ln3"], eps)
    return x


# -- heads / postnet ----------------------------------------------------------

def feat_and_prob(params, cfg: SpeechT5Config, hidden):
    """Hidden ``[B, T, D]`` -> (mel ``[B, T*r, n_mels]``, stop logits ``[B, T*r]``)."""
    B, T, _ = hidden.shape
    r = cfg.reduction_factor
    mel = L.linear(hidden, params["feat_out"]).reshape(B, T * r, cfg.num_mel_bins)
    logits = L.linear(hidden, params["prob_out"]).reshape(B, T * r)
    return mel, logits


def postnet(params, cfg: SpeechT5Config, mel):
    """Residual conv refinement of ``[B, T, n_mels]``."""
    x = mel
    pad = (cfg.speech_decoder_postnet_kernel - 1) // 2
    n = len(params["postnet"])
    for i, lp in enumerate(params["postnet"]):
        x = L.batch_norm_1d(L.conv1d(x, lp["conv"], padding=pad), lp["bn"])
        if i < n - 1:
            x = torch.tanh(x)
    return mel + x


# -- HF weight import ----------------------------------------------------------

#: state-dict keys ``port_from_hf`` does not read, each with its reason
HF_SKIPPED: Dict[str, str] = {
    r"speech_decoder_postnet\.layers\.\d+\.batch_norm\.num_batches_tracked":
        "a training counter; inference reads the running statistics",
}


def port_from_hf(model) -> Tuple[Dict[str, Any], SpeechT5Config]:
    """Port an HF ``SpeechT5ForTextToSpeech`` (or any object with its
    ``config`` and ``state_dict()``) to the port's tree, fp32 on the state
    dict's device."""
    hc = model.config
    cfg = SpeechT5Config(
        vocab_size=hc.vocab_size,
        hidden_size=hc.hidden_size,
        encoder_layers=hc.encoder_layers,
        encoder_attention_heads=hc.encoder_attention_heads,
        encoder_ffn_dim=hc.encoder_ffn_dim,
        decoder_layers=hc.decoder_layers,
        decoder_attention_heads=hc.decoder_attention_heads,
        decoder_ffn_dim=hc.decoder_ffn_dim,
        num_mel_bins=hc.num_mel_bins,
        reduction_factor=hc.reduction_factor,
        speech_decoder_prenet_layers=hc.speech_decoder_prenet_layers,
        speech_decoder_prenet_units=hc.speech_decoder_prenet_units,
        speech_decoder_prenet_dropout=hc.speech_decoder_prenet_dropout,
        speech_decoder_postnet_layers=hc.speech_decoder_postnet_layers,
        speech_decoder_postnet_units=hc.speech_decoder_postnet_units,
        speech_decoder_postnet_kernel=hc.speech_decoder_postnet_kernel,
        speaker_embedding_dim=hc.speaker_embedding_dim,
        max_text_positions=hc.max_text_positions,
        max_speech_positions=hc.max_speech_positions,
        encoder_max_relative_position=hc.encoder_max_relative_position,
        pad_token_id=hc.pad_token_id,
    )
    sd = HFStateDict(model, HF_SKIPPED)

    def mha(p):
        return {"q": sd.lin(f"{p}.q_proj"), "k": sd.lin(f"{p}.k_proj"),
                "v": sd.lin(f"{p}.v_proj"), "o": sd.lin(f"{p}.out_proj")}

    def ffn(p):
        return {"in": sd.lin(f"{p}.feed_forward.intermediate_dense"),
                "out": sd.lin(f"{p}.feed_forward.output_dense")}

    enc, dec = "speecht5.encoder", "speecht5.decoder"
    wenc, wdec = f"{enc}.wrapped_encoder", f"{dec}.wrapped_decoder"
    post = "speech_decoder_postnet"
    params: Dict[str, Any] = {
        "text_embed": {"w": sd.t(f"{enc}.prenet.embed_tokens.weight")},
        "enc_pos_alpha": sd.t(f"{enc}.prenet.encode_positions.alpha"),
        "enc_rel_pos": {"w": sd.t(f"{wenc}.embed_positions.pe_k.weight")},
        "enc_ln": sd.ln(f"{wenc}.layer_norm"),
        "enc_layers": L.stack_layers([
            {"attn": mha(f"{p}.attention"), "ln1": sd.ln(f"{p}.layer_norm"),
             "ffn": ffn(p), "ln2": sd.ln(f"{p}.final_layer_norm")}
            for p in (f"{wenc}.layers.{i}" for i in range(cfg.encoder_layers))]),
        "dec_prenet": {
            "layers": [sd.lin(f"{dec}.prenet.layers.{i}")
                       for i in range(cfg.speech_decoder_prenet_layers)],
            "final": sd.lin(f"{dec}.prenet.final_layer"),
            "pos_alpha": sd.t(f"{dec}.prenet.encode_positions.alpha"),
            "speaker": sd.lin(f"{dec}.prenet.speaker_embeds_layer"),
        },
        "dec_layers": L.stack_layers([
            {"self_attn": mha(f"{p}.self_attn"),
             "ln1": sd.ln(f"{p}.self_attn_layer_norm"),
             "cross_attn": mha(f"{p}.encoder_attn"),
             "ln2": sd.ln(f"{p}.encoder_attn_layer_norm"),
             "ffn": ffn(p), "ln3": sd.ln(f"{p}.final_layer_norm")}
            for p in (f"{wdec}.layers.{i}" for i in range(cfg.decoder_layers))]),
        "feat_out": sd.lin(f"{post}.feat_out"),
        "prob_out": sd.lin(f"{post}.prob_out"),
        "postnet": [
            {"conv": sd.conv(f"{post}.layers.{i}.conv"),
             "bn": {"g": sd.t(f"{post}.layers.{i}.batch_norm.weight"),
                    "b": sd.t(f"{post}.layers.{i}.batch_norm.bias"),
                    "running_mean": sd.t(f"{post}.layers.{i}.batch_norm.running_mean"),
                    "running_var": sd.t(f"{post}.layers.{i}.batch_norm.running_var")}}
            for i in range(cfg.speech_decoder_postnet_layers)],
    }
    sd.finish()
    return params, cfg
