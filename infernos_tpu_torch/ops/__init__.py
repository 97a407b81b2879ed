"""The port's CUDA kernels, each beside its plain PyTorch version.

:func:`launch_counts` reads every kernel mode's launch counter by name:
kernel 1 (``attention.fused_attention``) in bf16 and in fp32, kernel 2
(``tts_step.fused_decode_step``) with bf16 or int8 weights over bf16 or
fp32 caches.
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
}


def _entry(module: str):
    from . import attention, tts_step

    return attention.fused_attention if module == "attention" else tts_step.fused_decode_step


def launch_counts() -> Dict[str, int]:
    """Each kernel mode's launches so far, by the names of :data:`LAUNCH_COUNTERS`."""
    return {k: getattr(_entry(m), a) for k, (m, a) in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    """Every mode's launch counter to 0."""
    for m, a in LAUNCH_COUNTERS.values():
        setattr(_entry(m), a, 0)
