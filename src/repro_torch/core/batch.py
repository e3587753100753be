"""Batched personalization — one pass serves many PPR queries.

Port of ``repro/core/batch.py``.  A personalized-PageRank query is
PR(P, c, p_u) for a per-user preference vector p_u, and the graph operand
is identical across users, so a [B, n] batch reads the edge structure once
per round for all B queries (the batch ELL kernel's point).

Semantics: each batch row follows bit for bit the trajectory it would in
a sequential solve —

  * ITA rows that reach quiescence stop changing on their own (a quiet row
    pushes nothing), so running the batch until ALL rows are quiet leaves
    every row exactly where its own solve would;
  * power-method rows are frozen the iteration their residual crosses
    ``tol`` (a per-row ``done`` mask).

The reference's device ``while_loop`` becomes a host loop that reads the
stop condition once per round.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..device import synchronize
from ..graph.structure import Graph
from .backends import get_step_impl, ita_round

__all__ = ["BatchSolverResult", "ita_batch", "power_method_batch",
           "one_hot_personalizations"]


@dataclasses.dataclass
class BatchSolverResult:
    """Uniform return type for the batched solvers.

    ``pi`` is float[B, n], one normalized ranking row per personalization
    row; ``iterations`` is the shared synchronous-round count, ``residual``
    the stopping threshold the solve ran to (``xi`` for ITA, max row
    residual for power), ``converged`` whether every row met it within
    ``max_iter``, and ``method`` a tag like ``"ita_batch[ell]"``.
    """

    pi: torch.Tensor
    iterations: int
    residual: float
    converged: bool
    method: str
    batch: int
    wall_time_s: Optional[float] = None

    def stats(self) -> dict:
        return dict(method=self.method, batch=self.batch,
                    iterations=int(self.iterations),
                    residual=float(self.residual),
                    converged=bool(self.converged),
                    wall_time_s=self.wall_time_s)


def one_hot_personalizations(g: Graph, seeds, dtype=torch.float64) -> torch.Tensor:
    """[B, n] matrix of single-seed preference vectors (classic PPR).

    ``seeds`` is any int sequence/array of vertex ids (B entries; an empty
    list yields a valid [0, n] batch).  Duplicates are allowed and a
    dangling seed is legal.  As ``jax.nn.one_hot`` does in the reference,
    an id outside [0, n) gives an all-zero row.  Returns ``dtype``[B, n] on
    ``g``'s device.
    """
    seeds = torch.as_tensor(seeds, dtype=torch.int64).reshape(-1)
    P = torch.zeros((seeds.numel(), g.n), dtype=dtype)
    rows = torch.nonzero((seeds >= 0) & (seeds < g.n)).reshape(-1)
    P[rows, seeds[rows]] = 1.0
    return P.to(g.device)


def ita_batch(
    g: Graph,
    p_batch,
    *,
    c: float = 0.85,
    xi: float = 1e-10,
    max_iter: int = 10_000,
    dtype=torch.float64,
    step_impl: str = "dense",
    ctx=None,
    return_state: bool = False,
):
    """Multi-source ITA: ``p_batch`` is [B, n], one preference row per query.

    Initial information is ``p · n`` per the paper's uniform h0 = 1
    convention.  ``ctx`` injects a prepared backend context.  Returns a
    :class:`BatchSolverResult`; with ``return_state=True`` it returns
    ``(result, (PiBar, H))`` — the unnormalized per-row pairs at
    quiescence.
    """
    backend = get_step_impl(step_impl)
    if ctx is None:
        ctx = backend.prepare(g)
    H = torch.as_tensor(p_batch, device=g.device).to(dtype) * g.n
    t0 = time.perf_counter()
    inv_deg = g.inv_out_deg(dtype)
    non_dangling = torch.logical_not(g.dangling_mask)
    PiBar = torch.zeros_like(H)
    n_active, it = 1, 0
    while n_active > 0 and it < max_iter:
        H, PiBar, active = ita_round(lambda W: backend.push_batch(g, ctx, W),
                                     H, PiBar, c, xi, inv_deg, non_dangling)
        n_active = int(active.sum(dtype=torch.int64))
        it += 1
    U = PiBar + H
    Pi = U / torch.sum(U, dim=1, keepdim=True)
    synchronize(Pi.device)
    result = BatchSolverResult(
        pi=Pi, iterations=it, residual=float(xi), converged=n_active == 0,
        method=f"ita_batch[{step_impl}]", batch=int(H.shape[0]),
        wall_time_s=time.perf_counter() - t0)
    if return_state:
        return result, (PiBar, H)
    return result


def power_method_batch(
    g: Graph,
    p_batch,
    *,
    c: float = 0.85,
    tol: float = 1e-10,
    max_iter: int = 1000,
    dtype=torch.float64,
    step_impl: str = "dense",
    ctx=None,
) -> BatchSolverResult:
    """Batched power iteration with per-row freezing: rows freeze the
    iteration their own L2 residual crosses ``tol``."""
    backend = get_step_impl(step_impl)
    if ctx is None:
        ctx = backend.prepare(g)
    P = torch.as_tensor(p_batch, device=g.device).to(dtype)
    t0 = time.perf_counter()
    inv_deg = g.inv_out_deg(dtype)
    dmask = g.dangling_mask
    Pi = P
    Res = torch.full((P.shape[0],), float("inf"), dtype=dtype, device=g.device)
    it = 0
    while it < max_iter and bool(torch.any(Res > tol)):
        Y = c * backend.push_batch(g, ctx, Pi * inv_deg[None, :])
        dm = torch.sum(torch.where(dmask[None, :], Pi, 0.0), dim=1, keepdim=True)
        Pi_new = Y + (c * dm + (1.0 - c)) * P
        res_new = torch.linalg.vector_norm(Pi_new - Pi, dim=1)
        done = Res <= tol
        Pi = torch.where(done[:, None], Pi, Pi_new)
        Res = torch.where(done, Res, res_new)
        it += 1
    synchronize(Pi.device)
    return BatchSolverResult(
        pi=Pi, iterations=it, residual=float(torch.max(Res)),
        converged=bool(torch.all(Res <= tol)),
        method=f"power_batch[{step_impl}]", batch=int(P.shape[0]),
        wall_time_s=time.perf_counter() - t0)
