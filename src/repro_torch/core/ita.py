"""ITA — the Information Transmitting Algorithm (paper Algorithm 3).

Port of ``repro/core/ita.py``.  Every vertex holds ⟨pi_bar_i, h_i⟩; while
some *non-dangling* vertex has h_i > xi: pi_bar_i += h_i, push c·h_i/deg_i
along every out-edge, h_i = 0.  Dangling vertices never push — their
received information parks in h.  On termination
pi = (pi_bar + h) / Σ (pi_bar + h).

The schedule is the reference's synchronous bulk grouping (all active
vertices push at once), which the paper's §IV commutativity result makes
exact.  Operation accounting reproduces Formula (15):
m(t) = Σ_{v active at t} out_deg(v), M(T) = Σ_t m(t).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..device import synchronize
from ..graph.structure import Graph
from .backends import get_step_impl, ita_step_impl, run_ita_loop
from .metrics import SolverResult, err_max_rel, res_l2

__all__ = ["ita", "ita_traced", "ita_step", "ita_fixed_point"]


def ita_step(g: Graph, h, pi_bar, c: float, xi: float, inv_deg, non_dangling):
    """One synchronous ITA round on the ``"dense"`` backend.
    Returns ``(h', pi_bar', n_active, ops)``."""
    return ita_step_impl(get_step_impl("dense"), g, None, h, pi_bar, c, xi,
                         inv_deg, non_dangling)


def _default_h0(g: Graph, p, dtype) -> torch.Tensor:
    # Paper initialisation: h_i = 1 (== n * (e/n)).  For a general
    # personalisation p the information scale is n*p so xi keeps the same
    # per-vertex meaning as in the paper.
    if p is None:
        return torch.ones(g.n, dtype=dtype, device=g.device)
    return (torch.as_tensor(p, device=g.device) * g.n).to(dtype)


def _method(step_impl: str) -> str:
    return "ita" if step_impl == "dense" else f"ita[{step_impl}]"


def ita(
    g: Graph,
    *,
    c: float = 0.85,
    xi: float = 1e-10,
    p=None,
    max_iter: int = 10_000,
    dtype=torch.float64,
    step_impl: str = "dense",
    ctx=None,
) -> SolverResult:
    """Solve to quiescence on ``g``'s device.  ``ctx`` accepts a prepared
    backend context (``get_step_impl(step_impl).prepare(g)``) so a caller
    holding one skips re-preparation."""
    h0 = _default_h0(g, p, dtype)
    t0 = time.perf_counter()
    h, pi_bar, n_active, ops, it = run_ita_loop(
        g, h0, torch.zeros_like(h0), c=c, xi=xi, max_iter=max_iter,
        impl=step_impl, ctx=ctx)
    # Fold the in-flight residual — including everything parked on dangling
    # vertices — then normalize (Algorithm 3 final step).
    pi_bar = pi_bar + h
    pi = pi_bar / torch.sum(pi_bar)
    synchronize(pi.device)
    return SolverResult(
        pi=pi,
        iterations=it,
        residual=float(xi),
        ops=ops,
        converged=n_active == 0,
        method=_method(step_impl),
        wall_time_s=time.perf_counter() - t0,
    )


def ita_traced(
    g: Graph,
    *,
    c: float = 0.85,
    xi: float = 1e-10,
    p=None,
    max_iter: int = 10_000,
    dtype=torch.float64,
    pi_true: Optional[torch.Tensor] = None,
    step_impl: str = "dense",
    ctx=None,
) -> SolverResult:
    """Instrumented loop: per-iteration RES (between successive normalized
    estimates), active-set size (Management thread's CNT), per-round ops
    m(t), and ERR when a reference is provided."""
    backend = get_step_impl(step_impl)
    if ctx is None:
        ctx = backend.prepare(g)
    h = _default_h0(g, p, dtype)
    pi_bar = torch.zeros_like(h)
    inv_deg = g.inv_out_deg(dtype)
    non_dangling = torch.logical_not(g.dangling_mask)

    res_hist, active_hist, ops_hist, err_hist = [], [], [], []
    est_prev = None
    ops_total = 0.0
    it = 0
    t0 = time.perf_counter()
    while it < max_iter:
        h, pi_bar, n_active, ops = ita_step_impl(backend, g, ctx, h, pi_bar, c,
                                                 xi, inv_deg, non_dangling)
        n_active = int(n_active)
        if n_active == 0 and it > 0:
            break
        folded = pi_bar + h
        est = folded / torch.sum(folded)
        if est_prev is not None:
            res_hist.append(float(res_l2(est, est_prev)))
        if pi_true is not None:
            err_hist.append(float(err_max_rel(est, pi_true)))
        est_prev = est
        active_hist.append(n_active)
        ops_round = float(np.float32(int(ops)))  # the reference's float32 m(t)
        ops_hist.append(ops_round)
        ops_total += ops_round
        it += 1
        if n_active == 0:
            break
    pi_bar = pi_bar + h
    pi = pi_bar / torch.sum(pi_bar)
    synchronize(pi.device)
    out = SolverResult(
        pi=pi,
        iterations=it,
        residual=res_hist[-1] if res_hist else float("nan"),
        ops=ops_total,
        converged=True,
        method=_method(step_impl),
        res_history=res_hist,
        active_history=active_hist,
        ops_history=ops_hist,
        wall_time_s=time.perf_counter() - t0,
    )
    if pi_true is not None:
        out.err_history = err_hist  # type: ignore[attr-defined]
    return out


def ita_fixed_point(g: Graph, *, c: float = 0.85, dtype=torch.float64,
                    n_terms: int = 200, p=None) -> torch.Tensor:
    """Direct Neumann-series oracle  pi ∝ Σ_{r<n_terms} (cP)^r p  (Eq. 7).

    O(n_terms · m) — test/benchmark reference only, never the fast path.
    """
    from .propagate import spmv_p

    if p is None:
        p = torch.full((g.n,), 1.0 / g.n, dtype=dtype, device=g.device)
    term = torch.as_tensor(p, device=g.device).to(dtype)
    acc = term
    inv_deg = g.inv_out_deg(dtype)
    for _ in range(n_terms):
        term = c * spmv_p(g, term, inv_deg=inv_deg)
        acc = acc + term
    return acc / torch.sum(acc)
