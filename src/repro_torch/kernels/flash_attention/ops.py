"""Public flash-attention entry points; this module exists for path parity.

Port of ``src/repro/kernels/flash_attention/ops.py``.  The reference picks
the Pallas kernel on a TPU backend and its jnp oracle elsewhere, and
``force_pallas`` runs the kernel in interpret mode off the TPU.  Here the
wrappers in ``kernel.py`` already choose by the tensors' device (a CUDA
tensor runs the hand-written kernel, a CPU tensor its plain version in
``ref.py``), so the entry points are those wrappers under the reference's
names.  ``force_pallas`` has no meaning without an interpret mode and is
dropped.
"""
from __future__ import annotations

from .kernel import flash_decode, flash_prefill_causal

__all__ = ["attention_decode", "attention_prefill_causal"]

attention_decode = flash_decode
attention_prefill_causal = flash_prefill_causal
