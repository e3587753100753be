"""The single edge-propagation primitive (port of ``repro/core/propagate.py``).

    (P @ x)_i  =  sum_{j : (j->i) in E}  x_j / out_deg(j)

A pull over dst-sorted edges: gather ``x[src] * inv_deg[src]``, then a
*sorted* segment sum by ``dst``.  ``torch.segment_reduce`` over the
in-degree lengths sums each segment in a fixed order, with no atomics, so
the result does not change from run to run on the card.
"""
from __future__ import annotations

import torch

from ..graph.structure import Graph

__all__ = ["spmv_p", "push_weighted", "dangling_mass", "segment_sum_dst"]


def segment_sum_dst(g: Graph, contrib: torch.Tensor) -> torch.Tensor:
    """Sum per-edge values (last axis, dst-sorted) into their dst vertices.

    ``contrib`` is [m] or [B, m]; the result is [n] or [B, n].
    """
    lengths = g.in_deg.long()
    if contrib.dim() == 1:
        return torch.segment_reduce(contrib, "sum", lengths=lengths, unsafe=True)
    lengths = lengths.expand(contrib.shape[0], g.n).contiguous()
    return torch.segment_reduce(contrib, "sum", lengths=lengths, axis=1,
                                unsafe=True)


def spmv_p(g: Graph, x: torch.Tensor, *, inv_deg: torch.Tensor | None = None) -> torch.Tensor:
    """y = P @ x with the raw (dangling-preserving) transition matrix.

    Columns of P at dangling vertices are zero — mass sent *from* a dangling
    vertex is simply never gathered.
    """
    if inv_deg is None:
        inv_deg = g.inv_out_deg(x.dtype)
    return segment_sum_dst(g, (x * inv_deg)[g.src.long()])


def push_weighted(g: Graph, per_src: torch.Tensor) -> torch.Tensor:
    """Scatter an arbitrary per-source scalar along edges (no 1/deg scale)."""
    return segment_sum_dst(g, per_src[g.src.long()])


def dangling_mass(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """sum of x over dangling vertices — the power method's rank-1 term."""
    return torch.sum(torch.where(g.dangling_mask, x, 0.0))
