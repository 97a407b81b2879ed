"""Int8 weight-only quantization for the serving models.

Port of ``infernos_tpu/models/quant.py``: per-output-channel symmetric int8
for every linear weight.  ``layers.linear`` consumes a quantized node
(``{"w_q", "scale"[, "b"]}``) as ``(x @ w_q.to(x.dtype)) * scale + b``, and
the TTS decoder-step kernel chain streams the int8 codes themselves
(``ops/tts_step.py``), so the weights take a quarter of fp32's device
memory and a decode step reads half of what it reads in bf16.

Scales stay fp32 whatever the activation type: quantize AFTER casting the
dense tree (``cast_floating`` also leaves the ``scale`` of a quantized node
alone).  :func:`quantize_shardings` places a quantized tree over a ``tp``
mesh: quantize the whole tree first, then shard it (scales drawn per shard
would differ for row-parallel weights).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..parallel.mesh import P

#: path fragments whose weights are accessed directly (not via layers.linear)
#: and must stay dense
DEFAULT_EXCLUDE = ("embed", "pos", "lm_head", "bn", "postnet", "conv")


def quantize_linear(p: dict) -> dict:
    """{"w": [in,out](, "b")} -> {"w_q": int8, "scale": f32[out](, "b")}.

    Also takes layer-stacked weights ``[L, in, out]``: per-layer,
    per-out-channel scales ``[L, out]``, so each layer's slice is a normal
    quantized linear.
    """
    w = p["w"].float()
    amax = w.abs().amax(dim=-2).clamp_min(1e-8)  # per out-channel
    scale = amax / 127.0
    w_q = torch.round(w / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    out = {"w_q": w_q, "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _is_linear_leaf(node: Any) -> bool:
    return (isinstance(node, dict) and "w" in node
            and getattr(node["w"], "ndim", 0) in (2, 3)
            and set(node) <= {"w", "b"})


def quantize_params(params: Any, min_size: int = 4096,
                    exclude: Sequence[str] = DEFAULT_EXCLUDE) -> Any:
    """Walk a parameter tree quantizing linear-layer weight dicts."""

    def walk(node: Any, path: str) -> Any:
        if _is_linear_leaf(node):
            if any(x in path for x in exclude):
                return node
            if node["w"].numel() < min_size:
                return node
            return quantize_linear(node)
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return node

    return walk(params, "")


def quantize_shardings(specs: Any, qparams: Any) -> Any:
    """Dense-layout spec tree -> one matching a :func:`quantize_params`
    output.

    ``qparams`` (tensors, ``meta`` ones too) tells which linears got
    quantized; for those, ``w_q`` keeps the dense weight's spec and the
    per-out-channel ``scale`` keeps the spec's leading (layer-stack) and
    last (out-channel) axes, so a column-parallel weight's scales shard
    with it and a row-parallel weight's scales replicate."""

    def walk(spec, node):
        if isinstance(node, dict) and "w_q" in node:
            wspec = spec["w"]
            out = {"w_q": wspec, "scale": P(*wspec[:-2], wspec[-1])}
            if "b" in node:
                out["b"] = spec["b"]
            return out
        if isinstance(node, dict):
            return {k: walk(spec[k], v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(spec[i], v) for i, v in enumerate(node)]
        return spec

    return walk(specs, qparams)


def quantized_bytes(params: Any) -> int:
    """Bytes of every tensor leaf of a parameter tree."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
