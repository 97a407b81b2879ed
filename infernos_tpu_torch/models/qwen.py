"""Qwen2-class decoder-only LLM in PyTorch.

Port of ``infernos_tpu/models/qwen.py``: the same architecture and numerics
(HF ``Qwen2ForCausalLM``: RMSNorm in fp32, rotate-half RoPE with fp32
tables, GQA, SwiGLU, qkv bias) and the same parameter key paths, with the
layers stacked on a leading dim.  Attention is written as the reference
writes it (matmul, mask, fp32 softmax): the reference runs it as plain XLA,
not as a Pallas kernel.  GQA contracts each KV head against its group of
query heads (the group's rows stacked), so no repeated K/V is made.

What differs, and why:

- The cache is the canonical ``[L, B, Hkv, Tmax, Dh]``; :func:`decode_step`
  and :func:`verify_steps` write their K/V rows in place at each slot's
  position.  The reference's ring and merge (``init_ring``,
  ``decode_step_ring``, ``merge_ring``) exist only to avoid XLA scatter
  copies and are not ported.
- ``write`` ``[B]`` bool drops a slot's writes (a finished slot).  A row
  past ``Tmax`` is dropped too: the reference aims dropped writes at column
  ``Tmax`` and relies on its scatter to discard them, which torch would
  refuse.  :func:`verify_steps` drops the rows of a window that runs past
  ``Tmax`` where the reference's clamped update shifts the window back;
  only junk tokens past a slot's budget can tell them apart.

Tensor parallelism: :func:`param_shardings` and :func:`cache_shardings`
are the reference's specs, spec for spec (``parallel/mesh.py`` ``P``).  The
reference places the weights over a ``tp`` mesh axis and XLA inserts the
all-reduces; here each rank of a ``tp`` mesh holds its shards (column
shards of q/k/v/gate/up: ``num_heads/t`` query and ``num_kv_heads/t`` KV
heads; row shards of o/down) and :func:`prefill`, :func:`decode_step` and
:func:`verify_steps` take ``mesh=``: one sum over the group after o and
one after down (one per attention block and one per MLP, as XLA inserts
them), and the vocab-sharded readout's logits gathered.  A tied readout
uses the replicated embedding and needs no gather.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import P
from . import layers as L
from .convert import HFStateDict


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 152064
    hidden_size: int = 5120
    num_layers: int = 48
    num_heads: int = 40
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 13824
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    max_positions: int = 32768
    eos_token_id: int = 151645  # <|im_end|>
    tie_word_embeddings: bool = False


# -- init ---------------------------------------------------------------------

def _layer_init(g, cfg: QwenConfig, device, dtype):
    D, Hd = cfg.hidden_size, cfg.head_dim
    return {
        "ln1": {"g": torch.ones(D, device=device, dtype=dtype)},
        "q": L.linear_init(g, D, cfg.num_heads * Hd, device, dtype),
        "k": L.linear_init(g, D, cfg.num_kv_heads * Hd, device, dtype),
        "v": L.linear_init(g, D, cfg.num_kv_heads * Hd, device, dtype),
        "o": L.linear_init(g, cfg.num_heads * Hd, D, device, dtype, bias=False),
        "ln2": {"g": torch.ones(D, device=device, dtype=dtype)},
        "gate": L.linear_init(g, D, cfg.intermediate_size, device, dtype, bias=False),
        "up": L.linear_init(g, D, cfg.intermediate_size, device, dtype, bias=False),
        "down": L.linear_init(g, cfg.intermediate_size, D, device, dtype, bias=False),
    }


def init_params(cfg: QwenConfig, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict[str, Any]:
    """Seeded random parameters on ``device``: embedding and readout
    ``N(0, 0.02)``, linears torch.nn's default, norms ones."""
    g = generator
    p = {
        "embed": {"w": L.normal(g, (cfg.vocab_size, cfg.hidden_size), 0.02,
                                device, dtype)},
        "layers": L.stack_layers([_layer_init(g, cfg, device, dtype)
                                  for _ in range(cfg.num_layers)]),
        "ln_f": {"g": torch.ones(cfg.hidden_size, device=device, dtype=dtype)},
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = {"w": L.normal(g, (cfg.hidden_size, cfg.vocab_size), 0.02,
                                      device, dtype)}
    return p


def param_shardings(cfg: QwenConfig, tp_axis: str = "tp") -> Dict[str, Any]:
    """Spec tree matching :func:`init_params`' layout.

    Column-parallel q/k/v/gate/up (output dim sharded), row-parallel o/down
    (input dim sharded): one sum per attention and per MLP.
    """
    # layer-stacked weights carry a leading (unsharded) layer dim
    col = {"w": P(None, None, tp_axis), "b": P(None, tp_axis)}
    colnb = {"w": P(None, None, tp_axis)}
    row = {"w": P(None, tp_axis, None)}
    layer = {
        "ln1": {"g": P(None, None)}, "q": col, "k": col, "v": col, "o": row,
        "ln2": {"g": P(None, None)}, "gate": colnb, "up": colnb, "down": row,
    }
    out = {
        "embed": {"w": P(None, None)},
        "layers": layer,
        "ln_f": {"g": P(None)},
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = {"w": P(None, tp_axis)}
    return out


def shard_config(cfg: QwenConfig, mesh) -> QwenConfig:
    """The config one rank of a ``tp`` mesh computes with: its
    ``num_heads/t`` query heads and ``num_kv_heads/t`` KV heads."""
    if mesh is None:
        return cfg
    t = mesh.axis_size("tp")
    if cfg.num_heads % t or cfg.num_kv_heads % t:
        raise ValueError(f"qwen: {cfg.num_heads} query and {cfg.num_kv_heads} KV "
                         f"heads do not divide over tp {t}")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // t,
                               num_kv_heads=cfg.num_kv_heads // t)


def _psum(x, mesh):
    return x if mesh is None else mesh.psum(x, "tp")


def layer_list(params) -> List[Dict[str, Any]]:
    """The stacked layers as one dict of views per layer (slice once, not
    at every step)."""
    n = params["layers"]["ln1"]["g"].shape[0]
    return [L.layer_slice(params["layers"], i) for i in range(n)]


# -- core ops ------------------------------------------------------------------

def rms_norm(x, p, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return p["g"] * (xf * torch.rsqrt(var + eps)).to(x.dtype)


@lru_cache(maxsize=8)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def _rope_tables(cfg: QwenConfig, positions):
    """positions ``[...]`` -> (cos, sin) ``[..., head_dim]``, fp32."""
    inv = _inv_freq(cfg.head_dim, cfg.rope_theta, positions.device)
    freqs = positions[..., None].float() * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rope(x, cos, sin):
    """x ``[B, H, T, Dh]``; cos/sin ``[B, T, Dh]``; computed in fp32 and
    cast back."""
    cos, sin = cos[:, None], sin[:, None]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


class QwenCache(NamedTuple):
    k: torch.Tensor  # [L, B, Hkv, Tmax, Dh]
    v: torch.Tensor


def init_cache(cfg: QwenConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> QwenCache:
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return QwenCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


def cache_shardings(cfg: QwenConfig, tp_axis: str = "tp") -> QwenCache:
    return QwenCache(P(None, None, tp_axis), P(None, None, tp_axis))


def _qkv(lp, cfg: QwenConfig, h, cos, sin):
    """Projections of ``h`` ``[B, T, D]`` with RoPE: q ``[B, H, T, Dh]``,
    k and v ``[B, Hkv, T, Dh]``."""
    B, T, _ = h.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L.linear(h, lp["q"]).reshape(B, T, H, Dh).transpose(1, 2)
    k = L.linear(h, lp["k"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    v = L.linear(h, lp["v"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v


def _grouped_attention(cfg: QwenConfig, q, k, v, keep=None, bias=None):
    """q ``[B, H, T, Dh]`` against k/v ``[B, Hkv, S, Dh]``: each KV head
    serves its ``H // Hkv`` query heads.  ``keep`` bool broadcastable to
    ``[B, 1, 1, T, S]`` (False -> ``NEG_INF``); ``bias`` additive, the
    same shape.  Returns ``[B, T, H * Dh]``."""
    B, H, T, Dh = q.shape
    Hkv = cfg.num_kv_heads
    rep = H // Hkv
    S = k.shape[2]
    qg = q.reshape(B, Hkv, rep * T, Dh)
    logits = torch.matmul(qg, k.to(q.dtype).transpose(-1, -2)) * (Dh ** -0.5)
    logits = logits.reshape(B, Hkv, rep, T, S)
    if bias is not None:
        logits = logits + bias
    if keep is not None:
        logits = logits.masked_fill(~keep, L.NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.matmul(w.reshape(B, Hkv, rep * T, S), v.to(q.dtype))
    return out.reshape(B, H, T, Dh).transpose(1, 2).reshape(B, T, H * Dh)


def _mlp(lp, x):
    return L.linear(F.silu(L.linear(x, lp["gate"])) * L.linear(x, lp["up"]),
                    lp["down"])


def _readout(params, cfg: QwenConfig, x, mesh=None):
    head = params.get("lm_head")
    if head is None:
        return torch.matmul(x, params["embed"]["w"].transpose(0, 1))
    logits = torch.matmul(x, head["w"])
    return logits if mesh is None else mesh.gather_last(logits, cfg.vocab_size, "tp")


def prefill(params, cfg: QwenConfig, tokens, pos_offset=None, layers=None,
            mesh=None):
    """Teacher-forced pass over ``[B, T]`` tokens.

    Returns (logits ``[B, T, V]``, k-stack, v-stack ``[L, B, Hkv, T, Dh]``).
    ``pos_offset`` ``[B]`` shifts positions for continued sequences.
    ``layers``: :func:`layer_list` of ``params``, when the caller keeps one.
    ``mesh``: a ``tp`` mesh whose shards ``params`` are (the K/V stacks
    then hold this rank's ``Hkv/t`` heads; the logits are whole).
    """
    lc = shard_config(cfg, mesh)
    B, T = tokens.shape
    x = params["embed"]["w"][tokens]
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    if pos_offset is not None:
        positions = positions + pos_offset[:, None]
    cos, sin = _rope_tables(cfg, positions)
    mask = L.causal_bias(T, device=tokens.device)[:, :, None]  # [1, 1, 1, T, T]
    ks, vs = [], []
    for lp in layers or layer_list(params):
        q, k, v = _qkv(lp, lc, rms_norm(x, lp["ln1"], cfg.rms_norm_eps), cos, sin)
        x = x + _psum(L.linear(_grouped_attention(lc, q, k, v, bias=mask), lp["o"]), mesh)
        x = x + _psum(_mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_norm_eps)), mesh)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)
    return _readout(params, cfg, x, mesh), torch.stack(ks), torch.stack(vs)


def decode_step(params, cfg: QwenConfig, tokens, cache: QwenCache, pos,
                write=None, layers=None, mesh=None):
    """One token for all slots: tokens ``[B]``, pos ``[B]`` -> (logits
    ``[B, V]``, cache).

    Each slot writes its K/V row in place at its own position (a position
    past the end lands on the last row, the reference's clamped update);
    ``write`` ``[B]`` bool keeps the old row where False.  A slot attends to
    rows ``<= pos``.  ``mesh``: as in :func:`prefill` (the cache holds this
    rank's KV heads)."""
    lc = shard_config(cfg, mesh)
    x = params["embed"]["w"][tokens][:, None, :]  # [B, 1, D]
    cos, sin = _rope_tables(cfg, pos[:, None])  # [B, 1, Dh]
    Tmax = cache.k.shape[3]
    keep = None
    for i, lp in enumerate(layers or layer_list(params)):
        q, k, v = _qkv(lp, lc, rms_norm(x, lp["ln1"], cfg.rms_norm_eps), cos, sin)
        wp = L.write_rows(cache.k[i], k[:, :, 0], pos, write)
        L.write_rows(cache.v[i], v[:, :, 0], pos, write)
        if keep is None:  # [B, 1, 1, 1, Tmax]
            keep = (torch.arange(Tmax, device=x.device)[None, :]
                    <= wp[:, None])[:, None, None, None]
        x = x + _psum(L.linear(_grouped_attention(lc, q, cache.k[i], cache.v[i],
                                                  keep=keep), lp["o"]), mesh)
        x = x + _psum(_mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_norm_eps)), mesh)
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)[:, 0]
    return _readout(params, cfg, x, mesh), cache


def verify_steps(params, cfg: QwenConfig, tokens, cache: QwenCache, pos,
                 write=None, layers=None, mesh=None):
    """K-token speculative-verify pass: tokens ``[B, K]``, pos ``[B]``.

    Token j of each slot lands at position ``pos + j`` (its K/V written
    there in place; rows past ``Tmax`` and the rows of slots where
    ``write`` is False are dropped) and its query attends to rows
    ``<= pos + j``: a causal mini-prefill against the live cache.  Returns
    (logits ``[B, K, V]``, cache).  ``mesh``: as in :func:`decode_step`."""
    lc = shard_config(cfg, mesh)
    B, K = tokens.shape
    x = params["embed"]["w"][tokens]  # [B, K, D]
    positions = pos[:, None] + torch.arange(K, device=tokens.device)[None, :]
    cos, sin = _rope_tables(cfg, positions)  # [B, K, Dh]
    Tmax = cache.k.shape[3]
    kpos = torch.arange(Tmax, device=tokens.device)
    keep = (kpos[None, None, :] <= positions[:, :, None])[:, None, None]  # [B,1,1,K,Tmax]
    ok = [positions[:, j] < Tmax for j in range(K)]
    if write is not None:
        ok = [o & write for o in ok]
    for i, lp in enumerate(layers or layer_list(params)):
        q, k, v = _qkv(lp, lc, rms_norm(x, lp["ln1"], cfg.rms_norm_eps), cos, sin)
        for j in range(K):
            L.write_rows(cache.k[i], k[:, :, j], positions[:, j], ok[j])
            L.write_rows(cache.v[i], v[:, :, j], positions[:, j], ok[j])
        x = x + _psum(L.linear(_grouped_attention(lc, q, cache.k[i], cache.v[i],
                                                  keep=keep), lp["o"]), mesh)
        x = x + _psum(_mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_norm_eps)), mesh)
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)
    return _readout(params, cfg, x, mesh), cache


# -- HF weight import ----------------------------------------------------------

#: state-dict keys ``port_from_hf`` does not read, each with its reason
#: (a tied ``lm_head.weight`` is checked equal to the embedding instead)
HF_SKIPPED: Dict[str, str] = {
    r"model\.(layers\.\d+\.self_attn\.)?rotary_emb\.inv_freq":
        "RoPE frequencies, recomputed from rope_theta (older checkpoints "
        "saved the buffer)",
}


def port_from_hf(model) -> Tuple[Dict[str, Any], QwenConfig]:
    """Port an HF ``Qwen2ForCausalLM`` (or any object with its ``config``
    and ``state_dict()``) to the port's tree, fp32 on the state dict's
    device; ``lm_head`` only when the embeddings are untied."""
    hc = model.config
    cfg = QwenConfig(
        vocab_size=hc.vocab_size,
        hidden_size=hc.hidden_size,
        num_layers=hc.num_hidden_layers,
        num_heads=hc.num_attention_heads,
        num_kv_heads=hc.num_key_value_heads,
        head_dim=getattr(hc, "head_dim", None) or hc.hidden_size // hc.num_attention_heads,
        intermediate_size=hc.intermediate_size,
        rms_norm_eps=hc.rms_norm_eps,
        rope_theta=hc.rope_theta,
        max_positions=hc.max_position_embeddings,
        eos_token_id=(hc.eos_token_id if isinstance(hc.eos_token_id, int)
                      else (hc.eos_token_id or [QwenConfig.eos_token_id])[0]),
        tie_word_embeddings=hc.tie_word_embeddings,
    )
    sd = HFStateDict(model, HF_SKIPPED)
    params: Dict[str, Any] = {
        "embed": {"w": sd.t("model.embed_tokens.weight")},
        "layers": L.stack_layers([
            {"ln1": {"g": sd.t(f"{p}.input_layernorm.weight")},
             "q": sd.lin(f"{p}.self_attn.q_proj"),
             "k": sd.lin(f"{p}.self_attn.k_proj"),
             "v": sd.lin(f"{p}.self_attn.v_proj"),
             "o": sd.lin(f"{p}.self_attn.o_proj"),
             "ln2": {"g": sd.t(f"{p}.post_attention_layernorm.weight")},
             "gate": sd.lin(f"{p}.mlp.gate_proj"),
             "up": sd.lin(f"{p}.mlp.up_proj"),
             "down": sd.lin(f"{p}.mlp.down_proj")}
            for p in (f"model.layers.{i}" for i in range(cfg.num_layers))]),
        "ln_f": {"g": sd.t("model.norm.weight")},
    }
    if cfg.tie_word_embeddings:
        sd.tied("lm_head.weight", "model.embed_tokens.weight")
    else:
        params["lm_head"] = sd.lin("lm_head")
    sd.finish()
    return params, cfg
