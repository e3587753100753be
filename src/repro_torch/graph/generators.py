"""Synthetic directed-graph generators (port of ``repro/graph/generators.py``).

The paper's four web crawls (Table 3) are not shippable, so the data
pipeline generates *stat-matched* synthetic graphs: same vertex count,
edge count, dangling fraction and average degree, with power-law
in-degrees.  Everything is host-side numpy with an explicit seed and the
same sequence of generator calls as the reference, so one seed gives the
same arrays in both packages; only the finished arrays move to ``device``.
"""
from __future__ import annotations

import numpy as np

from ..device import DEFAULT_DEVICE
from .structure import Graph, _graph_from_sorted, _sorted_edges

__all__ = [
    "web_graph",
    "erdos_renyi",
    "random_dag",
    "TABLE3_PRESETS",
    "paper_dataset",
]


def _powerlaw_weights(n: int, gamma: float, rng: np.random.Generator) -> np.ndarray:
    """Zipf-ish attachment weights with random permutation (no id bias)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-gamma)
    rng.shuffle(w)
    return w / w.sum()


def _trimmed_graph(src, dst, n: int, m: int, rng: np.random.Generator,
                   device) -> Graph:
    """Dedup, then drop a random subset down to at most ``m`` edges.

    A sorted subset of dst-sorted unique edges is still dst-sorted and
    unique, so the reference's second ``graph_from_edges(dedup=False)``
    pass would return it unchanged and is skipped.
    """
    s, d = _sorted_edges(src, dst, n, dedup=True, drop_self_loops=False)
    if s.size > m:
        keep = np.sort(rng.choice(s.size, size=m, replace=False))
        s, d = s[keep], d[keep]
    return _graph_from_sorted(s, d, n, device)


def web_graph(
    n: int,
    m: int,
    *,
    dangling_frac: float = 0.1,
    unref_boost: float = 0.0,
    gamma_in: float = 0.9,
    gamma_out: float = 0.7,
    seed: int = 0,
    device=DEFAULT_DEVICE,
) -> Graph:
    """Power-law directed graph with a controlled dangling-vertex fraction.

    Construction:
      1. choose ``n_d = dangling_frac * n`` vertices to have out-degree 0;
      2. distribute the m edge *sources* over the remaining vertices with
         power-law(gamma_out) weights (heavy-tailed out-degrees);
      3. draw edge *destinations* from power-law(gamma_in) weights over all
         vertices; ``unref_boost`` re-weights a random subset to zero to
         force more unreferenced vertices.

    Self-loops are kept, duplicate edges are merged, and 3% extra edges
    are drawn so the dedup loss can be trimmed back to at most ``m``.
    """
    if not 0 <= dangling_frac < 1:
        raise ValueError("dangling_frac in [0,1)")
    rng = np.random.default_rng(seed)
    n_d = int(round(dangling_frac * n))
    perm = rng.permutation(n)
    non_dangling = perm[n_d:]

    w_out = _powerlaw_weights(non_dangling.size, gamma_out, rng)
    w_in = _powerlaw_weights(n, gamma_in, rng)
    if unref_boost > 0:
        kill = rng.random(n) < unref_boost
        w_in = np.where(kill, 0.0, w_in)
        w_in /= w_in.sum()

    m_draw = int(m * 1.03) + 8
    src = non_dangling[rng.choice(non_dangling.size, size=m_draw, p=w_out)]
    dst = rng.choice(n, size=m_draw, p=w_in)
    return _trimmed_graph(src, dst, n, m, rng, device)


def erdos_renyi(n: int, m: int, *, seed: int = 0, device=DEFAULT_DEVICE) -> Graph:
    """Uniform random directed graph (few special vertices — the control)."""
    rng = np.random.default_rng(seed)
    m_draw = int(m * 1.05) + 8
    src = rng.integers(0, n, size=m_draw)
    dst = rng.integers(0, n, size=m_draw)
    return _trimmed_graph(src, dst, n, m, rng, device)


def random_dag(n: int, m: int, *, seed: int = 0, device=DEFAULT_DEVICE) -> Graph:
    """Random DAG (edges only from lower to higher topological id)."""
    rng = np.random.default_rng(seed)
    m_draw = int(m * 1.1) + 8
    a = rng.integers(0, n, size=m_draw)
    b = rng.integers(0, n, size=m_draw)
    keep = a != b
    a, b = a[keep], b[keep]
    return _trimmed_graph(np.minimum(a, b), np.maximum(a, b), n, m, rng, device)


# Paper Table 3 presets — full-size stats, and a `scale` knob that runs
# the same *shape* of graph smaller.
TABLE3_PRESETS: dict[str, dict] = {
    # name:                n,        m,        nd,     deg
    "web-Stanford": dict(n=281_903, m=2_312_497, nd=172, deg=8.21),
    "Stanford-Berkeley": dict(n=683_446, m=7_583_376, nd=68_062, deg=12.32),
    "web-Google": dict(n=875_713, m=5_105_039, nd=136_259, deg=6.90),
    "in-2004": dict(n=1_382_870, m=16_917_053, nd=282_268, deg=15.37),
}


def paper_dataset(name: str, *, scale: float = 1.0, seed: int = 0,
                  device=DEFAULT_DEVICE) -> Graph:
    """Stat-matched synthetic stand-in for one of the paper's datasets.

    ``scale`` shrinks n and m proportionally (dangling fraction preserved).
    """
    p = TABLE3_PRESETS[name]
    n = max(int(p["n"] * scale), 64)
    m = max(int(p["m"] * scale), 4 * n)
    dangling_frac = p["nd"] / p["n"]
    return web_graph(n, m, dangling_frac=dangling_frac, seed=seed, device=device)
