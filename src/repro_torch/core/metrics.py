"""Convergence metrics (port of ``repro/core/metrics.py``).

The paper's §VI metrics:
  RES = ||pi(k) - pi(k-1)||_2      (successive-iterate residual)
  ERR = max_i |pi_i - pi*_i| / pi*_i   (max relative error vs. a reference)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["res_l2", "err_max_rel", "l1_diff", "SolverResult"]


def res_l2(pi_new: torch.Tensor, pi_old: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(pi_new - pi_old, ord=2)


def l1_diff(pi_new: torch.Tensor, pi_old: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(pi_new - pi_old))


def err_max_rel(pi: torch.Tensor, pi_true: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Paper's ERR.  ``eps`` guards division when a true value is ~0.

    Entries where ``max(|pi_true|, eps)`` is exactly 0 contribute their
    *absolute* error instead of dividing by zero.
    """
    denom = torch.clamp(torch.abs(pi_true), min=eps)
    safe = torch.where(denom > 0, denom, 1.0)
    return torch.max(torch.abs(pi - pi_true) / safe)


@dataclasses.dataclass
class SolverResult:
    """Uniform return type for every PageRank solver in ``repro_torch.core``.

    ``ops`` is the paper's operation count M(T): for the power method
    (2m+n) per iteration; for ITA the sum over iterations of the out-degree
    of the *active* frontier (Formula 15).
    """

    pi: torch.Tensor
    iterations: int
    residual: float
    ops: float
    converged: bool
    method: str
    # Optional per-iteration traces (instrumented loops only).
    res_history: Optional[list] = None
    active_history: Optional[list] = None
    ops_history: Optional[list] = None
    wall_time_s: Optional[float] = None

    def stats(self) -> dict:
        return dict(
            method=self.method,
            iterations=int(self.iterations),
            residual=float(self.residual),
            ops=float(self.ops),
            converged=bool(self.converged),
            wall_time_s=self.wall_time_s,
        )
