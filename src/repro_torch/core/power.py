"""Power method — the paper's primary baseline (port of ``repro/core/power.py``).

Solves  pi = P'' pi  with  P'' = c(P + p d^T) + (1-c) p e^T  by iterating

    pi(k+1) = c P pi(k) + c (d . pi(k)) p + (1-c) p

i.e. the dangling correction is the usual rank-1 update, never
materialising P' or P''.  Per-iteration cost is (2m + n) operations
(paper §V.D).  The SpMV goes through the backend layer: ``"dense"`` or the
``"ell"`` kernels.  The reference's device ``while_loop`` becomes a host
loop that reads the residual once per iteration.

Two entry points:
  * ``power_method``        — the solver;
  * ``power_method_traced`` — the same loop, keeping per-iteration RES/ERR.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..device import synchronize
from ..graph.structure import Graph
from .backends import SolverBackend, get_step_impl
from .metrics import SolverResult, err_max_rel, res_l2
from .propagate import dangling_mass

__all__ = ["power_method", "power_method_traced", "power_step"]


def power_step(g: Graph, pi: torch.Tensor, p: torch.Tensor, c: float,
               inv_deg: torch.Tensor) -> torch.Tensor:
    """One P'' application on the dense push."""
    return _power_step_impl(get_step_impl("dense"), g, None, pi, p, c, inv_deg)


def _power_step_impl(backend: SolverBackend, g: Graph, ctx, pi, p, c, inv_deg):
    """power_step with the SpMV routed through a backend."""
    y = c * backend.push(g, ctx, pi * inv_deg)
    dm = dangling_mass(g, pi)
    return y + (c * dm + (1.0 - c)) * p


def _default_p(g: Graph, p, dtype) -> torch.Tensor:
    if p is None:
        return torch.full((g.n,), 1.0 / g.n, dtype=dtype, device=g.device)
    return torch.as_tensor(p, device=g.device).to(dtype)


def power_method(
    g: Graph,
    *,
    c: float = 0.85,
    p=None,
    tol: float = 1e-10,
    max_iter: int = 1000,
    dtype=torch.float64,
    step_impl: str = "dense",
    ctx=None,
) -> SolverResult:
    backend = get_step_impl(step_impl)
    p = _default_p(g, p, dtype)
    if ctx is None:
        ctx = backend.prepare(g)
    inv_deg = g.inv_out_deg(dtype)
    t0 = time.perf_counter()
    pi, res, it = p, float("inf"), 0
    while res > tol and it < max_iter:
        pi_new = _power_step_impl(backend, g, ctx, pi, p, c, inv_deg)
        res = float(res_l2(pi_new, pi))
        pi = pi_new
        it += 1
    synchronize(pi.device)
    return SolverResult(
        pi=pi,
        iterations=it,
        residual=res,
        ops=float((2 * g.m + g.n) * it),
        converged=res <= tol,
        method="power" if step_impl == "dense" else f"power[{step_impl}]",
        wall_time_s=time.perf_counter() - t0,
    )


def power_method_traced(
    g: Graph,
    *,
    c: float = 0.85,
    p=None,
    tol: float = 1e-10,
    max_iter: int = 1000,
    dtype=torch.float64,
    pi_true: Optional[torch.Tensor] = None,
) -> SolverResult:
    """Instrumented loop: per-iteration residual history (and the ERR
    history in ``active_history`` when ``pi_true`` is given, as in the
    reference)."""
    p = _default_p(g, p, dtype)
    inv_deg = g.inv_out_deg(dtype)
    pi = p
    res_hist, err_hist = [], []
    t0 = time.perf_counter()
    it = 0
    res = float("inf")
    while res > tol and it < max_iter:
        pi_new = power_step(g, pi, p, c, inv_deg)
        res = float(res_l2(pi_new, pi))
        res_hist.append(res)
        if pi_true is not None:
            err_hist.append(float(err_max_rel(pi_new, pi_true)))
        pi = pi_new
        it += 1
    synchronize(pi.device)
    out = SolverResult(
        pi=pi,
        iterations=it,
        residual=res,
        ops=float((2 * g.m + g.n) * it),
        converged=res <= tol,
        method="power",
        res_history=res_hist,
        wall_time_s=time.perf_counter() - t0,
    )
    if pi_true is not None:
        out.active_history = err_hist  # reused field: ERR trace
    return out
