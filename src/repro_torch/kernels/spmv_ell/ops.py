"""Full-graph ELL push on the bucket kernels, and the ITA round built on it.

Port of ``src/repro/kernels/spmv_ell/ops.py``.  The reference adds its
overflow COO with ``jax.ops.segment_sum`` outside any kernel.  In web
graphs that overflow is a third of the edges on a few thousand rows (at
web-Google scale the heaviest row has 119,972 in-edges), so a port that
copies it puts most of the push outside the kernel, or walks the
heaviest row serially.
Here the overflow goes through the same bucket kernels instead:
:func:`prepare_push` cuts each heavy row's overflow tail into
sentinel-padded rows of width ``OVF_CHUNK``, and further levels of the
same kernel sum each row's chunk partials, ``OVF_CHUNK`` at a time, until
one partial per heavy row remains.  Every sum has a fixed order: the push
is deterministic, with no atomics.  The ``ELLGraph`` arrays stay as the
reference builds them.

Bucket rows are unique apart from the sentinel slot n, which only ever
receives zeros, so scattering bucket sums into ``y`` is an assignment and
needs no ordering.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...core.backends import ita_round
from ...sparse.ell import ELLGraph
from .kernel import spmv_ell_bucket, spmv_ell_bucket_batch

__all__ = ["OVF_CHUNK", "EllPush", "prepare_push", "spmv_ell",
           "spmv_ell_batch", "ita_step_ell"]

# width of an overflow chunk row and of each partial-sum level: the
# widest bucket, so the chunk rows take the kernel's warp-per-row path
OVF_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class EllPush:
    """An ``ELLGraph`` plus what its push needs beyond the reference arrays.

    ``row_ids`` holds each bucket's destination rows as int64 indices.
    ``ovf_levels[0]`` is an int32 [chunks, OVF_CHUNK] matrix of overflow
    source indices into the padded operand (sentinel n); ``ovf_levels[l]``
    for l > 0 indexes the padded partial sums of level l-1 (sentinel = their
    count).  The last level leaves one partial per entry of ``ovf_rows``,
    the heavy rows in ascending order.
    """

    ell: ELLGraph
    row_ids: tuple
    ovf_levels: tuple
    ovf_rows: torch.Tensor

    @property
    def n(self) -> int:
        return self.ell.n


def _chunk_rows(lengths: np.ndarray, values: np.ndarray, sentinel: int,
                width: int) -> tuple[np.ndarray, np.ndarray]:
    """Cut consecutive segments of ``values`` into sentinel-padded rows.

    Segment r holds the next ``lengths[r]`` entries of ``values``; it
    becomes ``ceil(lengths[r] / width)`` consecutive rows of ``width``
    entries, in order.  Returns (int32 [rows, width], rows per segment).
    """
    chunks = -(-lengths // width)
    idx = np.full((int(chunks.sum()), width), sentinel, dtype=np.int32)
    seg = np.repeat(np.arange(lengths.size), lengths)
    item_start = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    chunk_start = np.concatenate([[0], np.cumsum(chunks)[:-1]])
    j = np.arange(values.size, dtype=np.int64) - item_start[seg]
    idx[chunk_start[seg] + j // width, j % width] = values
    return idx, chunks


def prepare_push(ell: ELLGraph) -> EllPush:
    """Host-side, once per layout: index forms and the overflow chunk levels."""
    dev = ell.ovf_src.device
    for b in ell.buckets:
        if b.src_idx.numel() and (int(b.src_idx.min()) < 0
                                  or int(b.src_idx.max()) > ell.sentinel):
            raise ValueError(f"bucket k={b.k} holds an index outside [0, n]")
    levels = []
    ovf_dst = ell.ovf_dst.cpu().numpy()
    heavy = np.zeros(0, dtype=np.int64)
    if ovf_dst.size:
        heavy, counts = np.unique(ovf_dst, return_counts=True)
        idx, chunks = _chunk_rows(counts, ell.ovf_src.cpu().numpy(), ell.sentinel,
                                  OVF_CHUNK)
        levels.append(idx)
        while chunks.max() > 1:
            n_part = int(chunks.sum())
            idx, chunks = _chunk_rows(chunks, np.arange(n_part, dtype=np.int32),
                                      n_part, OVF_CHUNK)
            levels.append(idx)
    return EllPush(
        ell=ell,
        row_ids=tuple(b.row_ids.long() for b in ell.buckets),
        ovf_levels=tuple(torch.from_numpy(a).to(dev) for a in levels),
        ovf_rows=torch.from_numpy(heavy.astype(np.int64)).to(dev),
    )


def spmv_ell(push: EllPush, w: torch.Tensor) -> torch.Tensor:
    """y = (push of per-source scalar w) over all edges; shape [n] -> [n]."""
    wp = torch.cat([w, w.new_zeros(1)])
    y = w.new_zeros(push.n + 1)
    for b, rows in zip(push.ell.buckets, push.row_ids):
        y[rows] = spmv_ell_bucket(wp, b.src_idx)
    if push.ovf_levels:
        part = wp
        for level in push.ovf_levels:
            part = torch.cat([spmv_ell_bucket(part, level), w.new_zeros(1)])
        y[push.ovf_rows] += part[:-1]
    return y[: push.n]


def spmv_ell_batch(push: EllPush, W: torch.Tensor) -> torch.Tensor:
    """Batched push: [B, n] operand rows through one index stream.

    Row b is bitwise equal to ``spmv_ell(push, W[b])``: every step is the
    same per-row arithmetic, and the batch kernel matches the single one.
    """
    B = W.shape[0]
    Wp = torch.cat([W, W.new_zeros(B, 1)], dim=1)
    Y = W.new_zeros(B, push.n + 1)
    for b, rows in zip(push.ell.buckets, push.row_ids):
        Y[:, rows] = spmv_ell_bucket_batch(Wp, b.src_idx)
    if push.ovf_levels:
        part = Wp
        for level in push.ovf_levels:
            part = torch.cat([spmv_ell_bucket_batch(part, level),
                              W.new_zeros(B, 1)], dim=1)
        Y[:, push.ovf_rows] += part[:, :-1]
    return Y[:, : push.n]


def ita_step_ell(
    push: EllPush,
    h: torch.Tensor,
    pi_bar: torch.Tensor,
    c: float,
    xi: float,
    inv_deg: torch.Tensor,
    non_dangling: torch.Tensor,
):
    """One ITA round over the ELL layout — same contract as core.ita_step.

    Returns ``(h', pi_bar', n_active)`` with ``n_active`` a device scalar.
    """
    h, pi_bar, active = ita_round(functools.partial(spmv_ell, push), h, pi_bar,
                                  c, xi, inv_deg, non_dangling)
    return h, pi_bar, active.sum(dtype=torch.int32)
