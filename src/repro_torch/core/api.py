"""Solver API of the port (port of ``repro/core/api.py``).

This slice ports ``reference_pagerank`` alone; the ``SOLVERS`` registry and
the typed configs come with a later slice.
"""
from __future__ import annotations

import torch

from ..graph.structure import Graph
from .power import power_method

__all__ = ["reference_pagerank"]


def reference_pagerank(g: Graph, *, c: float = 0.85, p=None,
                       dtype=torch.float64) -> torch.Tensor:
    """High-accuracy reference pi (the paper's "true value" is the 210th
    power iteration; we iterate to machine-precision residual instead)."""
    return power_method(g, c=c, p=p, tol=1e-14, max_iter=500, dtype=dtype).pi
