"""Pluggable push backends (port of ``repro/core/backends.py``).

The paper's hot op is one push round: ``y[dst] += w[src]`` over every edge,
where ``w`` is the pre-scaled per-source value (``c·h·inv_deg`` for ITA,
``pi·inv_deg`` for the power method).  A registry of interchangeable
backends realises it, so the solvers pick a layout without changing
numerics (the paper's §IV commutativity result licenses the regrouping):

  * ``"dense"`` — sorted segment sum over all m COO edges
                  (``torch.segment_reduce``: fixed order, no atomics);
  * ``"ell"``   — the bucketed-ELL layout through the hand-written CUDA
                  kernels of ``repro_torch.kernels.spmv_ell``.

A backend is a :class:`SolverBackend` with ``prepare(g) -> ctx``,
``push(g, ctx, w)``, ``push_batch(g, ctx, W)``, a declared
:class:`BackendCapabilities` row and a rough ``cost()`` that
:func:`choose_backend` ranks for ``step_impl="auto"``.

The reference runs its ITA loop as a device ``while_loop``.  Here
:func:`run_ita_loop` is a host loop that reads the active count once per
round; the round body is the one :func:`ita_round` every solver shares.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..graph.structure import Graph
from .propagate import segment_sum_dst

__all__ = [
    "BackendCapabilities", "SolverBackend", "STEP_IMPLS",
    "default_platform", "register_step_impl", "get_step_impl",
    "available_step_impls", "resolve_step_impl", "choose_backend",
    "ita_round", "ita_step_impl", "run_ita_loop",
]


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What one edge layout can do — the planner's vocabulary.

    Only what this port's backends have: a batched push and the operand
    dtypes.  The reference's mesh, donation, dynamic-update and JIT flags
    arrive with the slices that bring those paths.
    """

    batched: bool = True
    dtypes: tuple = ("float32", "float64")

    def summary(self) -> str:
        return "batched" if self.batched else "none"


def _est_rounds(c: float = 0.85, tol: float = 1e-10) -> float:
    """Geometric-decay round estimate: residual ~ c^t ⇒ t ~ log tol / log c."""
    c = min(max(float(c), 1e-6), 1.0 - 1e-9)
    tol = min(max(float(tol), 1e-300), 1.0 - 1e-9)
    return max(1.0, math.log(tol) / math.log(c))


class SolverBackend:
    """Base class: one edge-propagation layout."""

    name: str = "?"
    capabilities_decl: Optional[BackendCapabilities] = None

    def prepare(self, g: Graph):
        """Per-graph context, built once outside the loop."""
        return None

    def push(self, g: Graph, ctx, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def push_batch(self, g: Graph, ctx, W: torch.Tensor) -> torch.Tensor:
        """[B, n] → [B, n]; default is one ``push`` per row."""
        return torch.stack([self.push(g, ctx, w) for w in W])

    def capabilities(self) -> BackendCapabilities:
        return self.capabilities_decl or BackendCapabilities()

    def cost(self, stats: Optional[dict] = None, cfg=None) -> float:
        """Rough per-solve cost in edge-traversal units (only the ranking
        across backends matters): one unit per edge per round."""
        m = float((stats or {}).get("m", 1) or 1)
        rounds = _est_rounds(getattr(cfg, "c", 0.85),
                             getattr(cfg, "xi", None)
                             or getattr(cfg, "tol", None) or 1e-10)
        return m * rounds


STEP_IMPLS: dict[str, SolverBackend] = {}


def register_step_impl(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register a backend under ``name``."""
    def deco(cls: type) -> type:
        inst = cls()
        inst.name = name
        STEP_IMPLS[name] = inst
        return cls
    return deco


def get_step_impl(name: str) -> SolverBackend:
    if name not in STEP_IMPLS:
        raise KeyError(
            f"unknown step_impl {name!r}; available: {sorted(STEP_IMPLS)}")
    return STEP_IMPLS[name]


def available_step_impls() -> list[str]:
    return sorted(STEP_IMPLS)


def default_platform() -> str:
    """``cuda`` when a card is present, else ``cpu`` (the planner's default)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def choose_backend(stats: Optional[dict] = None, cfg=None, *,
                   require: tuple = ()) -> tuple[str, str]:
    """Cost-based backend selection over the declared capability rows.

    Returns ``(name, reason)`` — the registered backend with the lowest
    :meth:`SolverBackend.cost` (ties broken toward "dense", then by name).
    ``stats`` may carry ``"m"`` and ``"platform"`` (``"cuda"`` or
    ``"cpu"``; default :func:`default_platform`), which the cost models
    read; ``require`` names capability flags every candidate must declare.  The reference's measured roofline re-ranking prices TPU HLO
    and its undirected-schedule rule belongs to ``frontier_priority``;
    neither is part of this slice.
    """
    cands = []
    for name, b in STEP_IMPLS.items():
        caps = b.capabilities()
        if any(not getattr(caps, r) for r in require):
            continue
        cands.append((b.cost(stats, cfg), 0 if name == "dense" else 1, name))
    if not cands:
        raise RuntimeError(
            "no eligible backend registered"
            + (f" (require={list(require)})" if require else ""))
    platform = (stats or {}).get("platform") or default_platform()
    _, _, name = min(cands)
    others = ", ".join(f"{n}={c:.3g}" for c, _, n in sorted(cands))
    reason = (f"lowest est. cost among eligible backends ({others}; "
              f"platform={platform}"
              + (f"; require={list(require)}" if require else "") + ")")
    return name, reason


def resolve_step_impl(name: Optional[str], platform: Optional[str] = None) -> str:
    """Map ``None``/"auto" to the cost-chosen backend for ``platform``
    (default :func:`default_platform`), else validate ``name``.  On the
    card the ELL kernels undercut dense; on the CPU dense wins."""
    if name is None or name == "auto":
        stats = {"platform": platform} if platform else None
        return choose_backend(stats)[0]
    get_step_impl(name)  # raise KeyError early for unknown names
    return name


@register_step_impl("dense")
class DenseBackend(SolverBackend):
    """Sorted segment sum over the full dst-sorted COO edge list."""

    def push(self, g: Graph, ctx, w: torch.Tensor) -> torch.Tensor:
        return segment_sum_dst(g, w[g.src.long()])

    def push_batch(self, g: Graph, ctx, W: torch.Tensor) -> torch.Tensor:
        # one gather + one segment sum over the trailing axis: the edge
        # index stream is read once per batch.
        return segment_sum_dst(g, W[:, g.src.long()])


@register_step_impl("ell")
class EllBackend(SolverBackend):
    """Bucketed-ELL layout, CUDA bucket kernels on the push."""

    def cost(self, stats: Optional[dict] = None, cfg=None) -> float:
        # The hand-written kernels undercut the gather + segment sum on the
        # card (the reference's "tpu" branch); on the CPU the push is the
        # plain version of a kernel, so a large declared penalty keeps
        # "auto" on dense there.
        platform = (stats or {}).get("platform") or default_platform()
        factor = 0.35 if platform == "cuda" else 50.0
        return super().cost(stats, cfg) * factor

    def prepare(self, g: Graph):
        from ..kernels.spmv_ell import prepare_push
        return prepare_push(g.ell())

    def push(self, g: Graph, ctx, w: torch.Tensor) -> torch.Tensor:
        from ..kernels.spmv_ell import spmv_ell
        return spmv_ell(ctx, w)

    def push_batch(self, g: Graph, ctx, W: torch.Tensor) -> torch.Tensor:
        from ..kernels.spmv_ell import spmv_ell_batch
        return spmv_ell_batch(ctx, W)


def ita_round(push: Callable[[torch.Tensor], torch.Tensor], h, pi_bar, c, xi,
              inv_deg, non_dangling):
    """The one ITA round body every solver shares: ``(h', pi_bar', active)``.

    ``push`` maps the scaled operand to the pushed values.  ``h`` and
    ``pi_bar`` are [n], or [B, n] with a batched ``push``; ``inv_deg`` and
    ``non_dangling`` are [n] and broadcast over the batch.
    """
    active = torch.logical_and(h > xi, non_dangling)
    h_act = torch.where(active, h, 0.0)
    pi_bar = pi_bar + h_act
    pushed = push(h_act * inv_deg * c)
    h = torch.where(active, 0.0, h) + pushed
    return h, pi_bar, active


def ita_step_impl(backend: SolverBackend, g: Graph, ctx, h, pi_bar, c, xi,
                  inv_deg, non_dangling):
    """One synchronous ITA round over any backend.

    Returns ``(h', pi_bar', n_active, ops)``, the last two as int64 device
    scalars.  ``ops`` is Formula 15's m(t), the out-degree sum over the
    active set, taken exactly; the reference sums it in float32, which is
    the same number while it stays below 2^24.
    """
    h, pi_bar, active = ita_round(lambda w: backend.push(g, ctx, w), h, pi_bar,
                                  c, xi, inv_deg, non_dangling)
    n_active = active.sum(dtype=torch.int64)
    ops = torch.where(active, g.out_deg, 0).sum(dtype=torch.int64)
    return h, pi_bar, n_active, ops


def run_ita_loop(g: Graph, h0, pi_bar0, *, c: float, xi: float,
                 max_iter: int, impl: str = "dense", ctx=None):
    """Run ITA rounds to quiescence over the named backend.

    A host loop: the active count and m(t) are read together once per
    round.  ``ops`` accumulates in float32 in round order, as the
    reference's device loop does, so the totals agree past 2^24.
    Returns ``(h, pi_bar, n_active, ops_total, iterations)`` with the last
    three as Python numbers.
    """
    backend = get_step_impl(impl)
    if ctx is None:
        ctx = backend.prepare(g)
    inv_deg = g.inv_out_deg(h0.dtype)
    non_dangling = torch.logical_not(g.dangling_mask)
    h, pi_bar = h0, pi_bar0
    n_active, it = 1, 0
    ops_total = np.float32(0.0)
    while n_active > 0 and it < max_iter:
        h, pi_bar, na, ops = ita_step_impl(backend, g, ctx, h, pi_bar, c, xi,
                                           inv_deg, non_dangling)
        n_active, ops_round = torch.stack([na, ops]).tolist()
        ops_total = np.float32(ops_total + np.float32(ops_round))
        it += 1
    return h, pi_bar, n_active, float(ops_total), it
