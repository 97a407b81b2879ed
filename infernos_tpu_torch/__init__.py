"""PyTorch/CUDA port of the Infernos speech path for NVIDIA Hopper.

``infernos_tpu`` (JAX) stays the reference; this package mirrors its module
names so each module's counterpart is easy to find.  It imports ``torch``
and ``numpy`` only.  The two Pallas kernels of the reference are rewritten
as hand-written CUDA C++ under ``csrc/`` and built on first use by
:mod:`infernos_tpu_torch.ops.build`.  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
