"""Plain PyTorch versions of the two ELL bucket kernels.

These are what the kernel wrappers compute on a CPU tensor, and what
``chip_smoke.py`` and the card-marked tests hold the CUDA kernels against.
"""
from __future__ import annotations

import torch

from ...sparse.ell import spmv_ell_ref

__all__ = ["spmv_ell_bucket_ref", "spmv_ell_bucket_batch_ref", "spmv_ell_ref"]


def spmv_ell_bucket_ref(w_padded: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_k w_padded[src_idx[r, k]] — the single-vector kernel's contract."""
    return w_padded[src_idx.long()].sum(-1)


def spmv_ell_bucket_batch_ref(w_padded: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """Y[b, r] = sum_k w_padded[b, src_idx[r, k]] — the batch kernel's contract."""
    return w_padded[:, src_idx.long()].sum(-1)
