"""The port's CUDA kernels, each beside its plain PyTorch version.

:func:`launch_counts` reads every kernel mode's launch counter by name:
kernel 1 (``attention.fused_attention``) in bf16 and in fp32, kernel 2
(``tts_step.fused_decode_step``) with bf16 or int8 weights over bf16 or
fp32 caches, and the int8-direct cross-attention core
(``cross_attention_i8.cross_attention_i8``, a port of an XLA path of the
reference, not of a Pallas kernel).
"""

from __future__ import annotations

from typing import Dict

# name -> (module, counter attribute of its entry point)
LAUNCH_COUNTERS = {
    "attention": ("attention", "launches"),
    "attention_fp32": ("attention", "launches_fp32"),
    "bf16_step": ("tts_step", "launches"),
    "int8_step": ("tts_step", "launches_int8"),
    "fp32_step": ("tts_step", "launches_fp32"),
    "int8_fp32_step": ("tts_step", "launches_int8_fp32"),
    "cross_i8": ("cross_attention_i8", "launches"),
}


def _entry(module: str):
    from . import attention, cross_attention_i8, tts_step

    return {"attention": attention.fused_attention,
            "tts_step": tts_step.fused_decode_step,
            "cross_attention_i8": cross_attention_i8.cross_attention_i8}[module]


def launch_counts() -> Dict[str, int]:
    """Each kernel mode's launches so far, by the names of :data:`LAUNCH_COUNTERS`."""
    return {k: getattr(_entry(m), a) for k, (m, a) in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    """Every mode's launch counter to 0."""
    for m, a in LAUNCH_COUNTERS.values():
        setattr(_entry(m), a, 0)
