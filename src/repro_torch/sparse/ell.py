"""Bucketed ELLPACK (padded-CSR) layout (port of ``repro/sparse/ell.py``).

The dst-sorted edge list is re-blocked into ELL buckets:

  * rows (= destination vertices) are grouped by in-degree into buckets
    with padded widths k (8, 32, 128 by default);
  * each bucket is a dense int32 [rows_b, k_b] matrix of *source* indices,
    padded with a sentinel index n that points at an appended zero slot of
    the operand vector, so gathers of the sentinel contribute exactly 0;
  * rows with in-degree > k_max keep their first k_max sources in the last
    bucket and spill the rest to an overflow COO sorted by dst.

The arrays are those the reference builds, array for array; the host
conversion is vectorised instead of looping over rows.  This is the layout
consumed by the CUDA kernels in ``repro_torch.kernels.spmv_ell``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..graph.structure import Graph

__all__ = ["ELLBucket", "ELLGraph", "ell_from_graph", "spmv_ell_ref"]


@dataclasses.dataclass(frozen=True)
class ELLBucket:
    row_ids: torch.Tensor   # int32[rows_b]  — destination vertex of each row
    src_idx: torch.Tensor   # int32[rows_b, k_b] — source indices, sentinel-padded
    k: int
    rows: int


@dataclasses.dataclass(frozen=True)
class ELLGraph:
    buckets: tuple            # tuple[ELLBucket, ...]
    ovf_src: torch.Tensor     # int32 overflow COO (sorted by dst)
    ovf_dst: torch.Tensor
    n: int
    m: int
    sentinel: int             # == n

    def fill_stats(self) -> dict:
        padded = sum(b.rows * b.k for b in self.buckets)
        n_ovf = int(self.ovf_src.shape[0])
        return dict(
            padded_slots=padded,
            real_edges=self.m,
            overflow_edges=n_ovf,
            fill_ratio=padded / max(self.m - n_ovf, 1),
            n_buckets=len(self.buckets),
        )


def ell_from_graph(
    g: Graph,
    *,
    widths: Sequence[int] = (8, 32, 128),
    row_align: int = 8,
) -> ELLGraph:
    """Host-side conversion (one-time data-pipeline work)."""
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    in_deg = g.in_deg.cpu().numpy()
    n = g.n
    dev = g.device
    widths = sorted(widths)
    k_max = widths[-1]

    # CSR over dst (edges already dst-sorted)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(in_deg, out=offsets[1:])

    buckets = []
    prev_w = 0
    for w in widths:
        if w == k_max:
            rows = np.nonzero(in_deg > prev_w)[0]
        else:
            rows = np.nonzero((in_deg > prev_w) & (in_deg <= w))[0]
        prev_w = w
        if rows.size == 0:
            continue
        rows_pad = int(np.ceil(rows.size / row_align) * row_align)
        idx = np.full((rows_pad, w), n, dtype=np.int32)  # sentinel = n
        cols = np.arange(w, dtype=np.int64)
        filled = cols[None, :] < np.minimum(in_deg[rows], w)[:, None]
        pos = offsets[rows][:, None] + cols[None, :]
        idx[: rows.size][filled] = src[pos[filled]]
        row_ids = np.full((rows_pad,), n, dtype=np.int32)
        row_ids[: rows.size] = rows
        buckets.append(ELLBucket(
            row_ids=torch.from_numpy(row_ids).to(dev),
            src_idx=torch.from_numpy(idx).to(dev),
            k=int(w),
            rows=rows_pad,
        ))

    # Overflow: every edge past the first k_max of its dst row.  Rows are
    # walked in ascending order and edges are dst-sorted, so edge order is
    # already the reference's stable dst order.
    rank = np.arange(src.size, dtype=np.int64) - offsets[dst]
    spill = rank >= k_max
    return ELLGraph(
        buckets=tuple(buckets),
        ovf_src=torch.from_numpy(np.ascontiguousarray(src[spill], np.int32)).to(dev),
        ovf_dst=torch.from_numpy(np.ascontiguousarray(dst[spill], np.int32)).to(dev),
        n=n,
        m=g.m,
        sentinel=n,
    )


def spmv_ell_ref(ell: ELLGraph, w: torch.Tensor) -> torch.Tensor:
    """Plain-torch oracle:  y[dst] = sum over in-edges of w[src].

    ``w`` is the *pre-scaled* per-source value (e.g. c*h*inv_deg for ITA);
    shape [n].  Returns shape [n].  Bucket rows are unique apart from the
    sentinel slot n, which only ever receives zeros, so the scatter is a
    plain assignment; the overflow is a sorted segment sum.
    """
    wp = torch.cat([w, w.new_zeros(1)])  # sentinel slot
    y = w.new_zeros(ell.n + 1)
    for b in ell.buckets:
        y[b.row_ids.long()] = wp[b.src_idx.long()].sum(1)
    if ell.ovf_src.shape[0]:
        lengths = torch.bincount(ell.ovf_dst.long(), minlength=ell.n)
        y[: ell.n] += torch.segment_reduce(w[ell.ovf_src.long()], "sum",
                                           lengths=lengths, unsafe=True)
    return y[: ell.n]
