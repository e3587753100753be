"""repro_torch — the PyTorch/CUDA port of the ``repro`` PageRank system.

It mirrors ``src/repro/`` module for module (``repro_torch/core/ita.py``
answers to ``repro/core/ita.py``) and imports neither JAX nor ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the hand-written Hopper kernels live under ``repro_torch.kernels``.
"""
__version__ = "0.1.0"
