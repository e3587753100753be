"""Graph container used by every sparse layer of the port.

Port of ``repro/graph/structure.py``.  The representation is the same
dst-sorted int32 COO edge list plus per-vertex degree metadata, held as
torch tensors on one device:

  - edges are sorted by (dst, src), so the push is a *sorted* segment
    reduction: deterministic, with no atomics;
  - all index arrays are int32, which halves index bandwidth against int64
    on a push that is bandwidth-bound.

Construction is host-side numpy, exactly as in the reference, so the same
inputs give the same arrays; only the finished arrays move to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["Graph", "graph_from_arrays", "graph_from_edges", "validate_graph",
           "csr_from_graph"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed graph in dst-sorted COO form.

    Attributes
    ----------
    src, dst : int32[m]
        Edge endpoints, sorted by (dst, src).  Edge ``(src[k], dst[k])``
        means information flows ``src[k] -> dst[k]``.
    out_deg : int32[n]
        Out-degree per vertex.  ``out_deg[i] == 0``  ⇔  dangling vertex.
    in_deg : int32[n]
        In-degree per vertex.   ``in_deg[i] == 0``   ⇔  unreferenced vertex.
    n, m : vertex and edge counts.
    """

    src: torch.Tensor
    dst: torch.Tensor
    out_deg: torch.Tensor
    in_deg: torch.Tensor
    n: int
    m: int
    # (widths, row_align) -> ELLGraph, filled by ell(); not part of equality
    _ell_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def dangling_mask(self) -> torch.Tensor:
        """bool[n] — vertices with no out-edges (the paper's V_D)."""
        return self.out_deg == 0

    @property
    def unreferenced_mask(self) -> torch.Tensor:
        """bool[n] — vertices with no in-edges (exit after one push)."""
        return self.in_deg == 0

    @property
    def n_dangling(self) -> int:
        return int(self.dangling_mask.sum())

    @property
    def avg_degree(self) -> float:
        return self.m / max(self.n, 1)

    def inv_out_deg(self, dtype=torch.float64) -> torch.Tensor:
        """1/deg with 0 at dangling vertices (the raw-P column scale)."""
        deg = self.out_deg.to(dtype)
        return torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 0.0)

    def stats(self) -> dict:
        """Host-side summary matching the paper's Table 3 columns."""
        return dict(
            n=self.n,
            m=self.m,
            nd=self.n_dangling,
            n_unref=int(self.unreferenced_mask.sum()),
            deg=round(self.avg_degree, 2),
        )

    def ell(self, *, widths: tuple = (8, 32, 128), row_align: int = 8):
        """Bucketed-ELL view of this graph (``repro_torch.sparse.ell``), cached.

        Conversion is host-side O(m) work paid once per (graph, widths)
        pair; the buckets live on the graph's device.
        """
        key = (tuple(sorted(widths)), int(row_align))
        if key not in self._ell_cache:
            from ..sparse.ell import ell_from_graph
            self._ell_cache[key] = ell_from_graph(self, widths=key[0],
                                                  row_align=row_align)
        return self._ell_cache[key]


def _sorted_edges(src, dst, n: int, *, dedup: bool,
                  drop_self_loops: bool) -> tuple[np.ndarray, np.ndarray]:
    """The reference's host-side edge canonicalisation, as numpy arrays."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst must be equal-length 1-D, got {src.shape} {dst.shape}")
    if src.size:
        if src.min() < 0 or src.max() >= n or dst.min() < 0 or dst.max() >= n:
            raise ValueError("edge endpoint out of range")
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    if dedup and src.size:
        # unique over (dst, src) pairs; also yields the dst-major sort we want.
        key = np.unique(dst * np.int64(n) + src)
        return (key % n).astype(np.int32), (key // n).astype(np.int32)
    order = np.lexsort((src, dst))
    return src[order].astype(np.int32), dst[order].astype(np.int32)


def graph_from_arrays(src, dst, out_deg, in_deg, n: int, *,
                      device=DEFAULT_DEVICE) -> Graph:
    """:class:`Graph` from finished host arrays (e.g. the reference graph's).

    The arrays are taken as they are (no sort, no dedup), so a graph built
    by another implementation carries over array for array.
    """
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)  # a copy

    src_t = put(src)
    return Graph(src=src_t, dst=put(dst), out_deg=put(out_deg),
                 in_deg=put(in_deg), n=int(n), m=int(src_t.numel()))


def _graph_from_sorted(src: np.ndarray, dst: np.ndarray, n: int,
                       device) -> Graph:
    out_deg = np.bincount(src, minlength=n).astype(np.int32)
    in_deg = np.bincount(dst, minlength=n).astype(np.int32)
    return graph_from_arrays(src, dst, out_deg, in_deg, n, device=device)


def graph_from_edges(
    src,
    dst,
    n: int,
    *,
    dedup: bool = True,
    drop_self_loops: bool = False,
    device=DEFAULT_DEVICE,
) -> Graph:
    """Build a dst-sorted :class:`Graph` from host edge arrays.

    Host-side (numpy) on purpose: graph construction is data-pipeline work,
    done once per dataset; the resulting arrays live on ``device``.
    """
    s, d = _sorted_edges(src, dst, n, dedup=dedup,
                         drop_self_loops=drop_self_loops)
    return _graph_from_sorted(s, d, n, device)


def validate_graph(g: Graph) -> None:
    """Cheap invariants; raises ``ValueError`` on the first one broken."""
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    if src.shape != (g.m,) or dst.shape != (g.m,):
        raise ValueError(f"edge arrays must be [m={g.m}]")
    if tuple(g.out_deg.shape) != (g.n,) or tuple(g.in_deg.shape) != (g.n,):
        raise ValueError(f"degree arrays must be [n={g.n}]")
    if int(g.out_deg.sum()) != g.m or int(g.in_deg.sum()) != g.m:
        raise ValueError("degree sums must equal m")
    if g.m and not np.all(np.diff(dst.astype(np.int64) * g.n + src) > 0):
        raise ValueError("edges not dst-sorted/unique")


def csr_from_graph(g: Graph, by: str = "src") -> tuple[np.ndarray, np.ndarray]:
    """Host-side CSR (offsets, indices).

    ``by='src'`` gives out-neighbour lists; ``by='dst'`` gives in-neighbour
    lists (edges are already dst-sorted).
    """
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    if by == "src":
        order = np.argsort(src, kind="stable")
        vals = dst[order]
        deg = g.out_deg.cpu().numpy()
    elif by == "dst":
        vals = src
        deg = g.in_deg.cpu().numpy()
    else:
        raise ValueError(by)
    offsets = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(deg, out=offsets[1:])
    return offsets, vals.astype(np.int32)
