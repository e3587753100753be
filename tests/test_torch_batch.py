"""Port parity: batched personalized PageRank (``core/batch.py``).

``ita_batch`` and ``power_method_batch`` on dense and ell against the
reference on the same one-hot batches (π within 1e-12, iteration counts
equal), and the batch-row invariance the reference promises: each row of
an ``ita_batch`` is bitwise the state its own sequential solve reaches.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import host, port_graph

from repro.core import batch as jbatch
from repro.graph import generators as jgen
from repro_torch.core import backends as tbackends
from repro_torch.core import batch as tbatch

ATOL = 1e-12

GRAPHS = {
    "web": lambda: jgen.web_graph(1500, 12000, dangling_frac=0.15, seed=1),
    "google": lambda: jgen.paper_dataset("web-Google", scale=0.002, seed=0),
    "dag": lambda: jgen.random_dag(600, 3000, seed=3),
}


@functools.lru_cache(maxsize=None)
def graphs(name):
    gj = GRAPHS[name]()
    return gj, port_graph(gj)


def _seeds(gj, B, seed=0):
    # include a dangling seed: its row's mass never transmits
    seeds = np.random.default_rng(seed).choice(gj.n, size=B, replace=False)
    dangling = np.nonzero(host(gj.dangling_mask))[0]
    seeds[-1] = dangling[0]
    return seeds


@pytest.mark.parametrize("graph,impl", [("web", "dense"), ("web", "ell"),
                                        ("google", "ell"), ("dag", "dense")])
def test_ita_batch_matches_reference(graph, impl):
    gj, gt = graphs(graph)
    seeds = _seeds(gj, 6)
    rj, (pb_j, h_j) = jbatch.ita_batch(gj, jbatch.one_hot_personalizations(gj, seeds),
                                       step_impl=impl, return_state=True)
    Pt = tbatch.one_hot_personalizations(gt, seeds)
    rt, (pb_t, h_t) = tbatch.ita_batch(gt, Pt, step_impl=impl, return_state=True)
    assert (rt.iterations, rt.converged, rt.batch) == (rj.iterations, rj.converged, rj.batch)
    assert rt.method == rj.method
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)
    scale = gj.n  # the state carries the paper's h0 = n·p scale
    np.testing.assert_allclose(host(pb_t), host(pb_j), rtol=0, atol=ATOL * scale)
    np.testing.assert_allclose(host(h_t), host(h_j), rtol=0, atol=ATOL * scale)
    # a dangling seed ranks only itself
    np.testing.assert_array_equal(host(rt.pi[-1]), host(Pt[-1]))


@pytest.mark.parametrize("graph,impl", [("web", "dense"), ("web", "ell")])
def test_power_method_batch_matches_reference(graph, impl):
    gj, gt = graphs(graph)
    seeds = _seeds(gj, 4, seed=1)
    rj = jbatch.power_method_batch(gj, jbatch.one_hot_personalizations(gj, seeds),
                                   step_impl=impl)
    rt = tbatch.power_method_batch(gt, tbatch.one_hot_personalizations(gt, seeds),
                                   step_impl=impl)
    assert (rt.iterations, rt.converged) == (rj.iterations, rj.converged)
    assert rt.method == rj.method
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rt.residual, rj.residual, rtol=0, atol=1e-14)


@pytest.mark.parametrize("impl", ["ell", "dense"])
@pytest.mark.parametrize("graph", ["web", "google"])
def test_batch_rows_bitwise_equal_sequential_solves(graph, impl):
    gj, gt = graphs(graph)
    seeds = _seeds(gj, 5, seed=2)
    P = tbatch.one_hot_personalizations(gt, seeds)
    backend = tbackends.get_step_impl(impl)
    ctx = backend.prepare(gt)
    _, (PiBar, H) = tbatch.ita_batch(gt, P, step_impl=impl, ctx=ctx, return_state=True)
    for b in range(len(seeds)):
        h0 = P[b] * gt.n
        h, pi_bar, n_active, _, _ = tbackends.run_ita_loop(
            gt, h0, torch.zeros_like(h0), c=0.85, xi=1e-10, max_iter=10_000,
            impl=impl, ctx=ctx)
        assert n_active == 0
        assert torch.equal(PiBar[b] + H[b], pi_bar + h), f"row {b}"


def test_one_hot_personalizations():
    gj, gt = graphs("dag")
    seeds = [3, 3, 0, gt.n - 1]
    P = tbatch.one_hot_personalizations(gt, seeds)
    np.testing.assert_array_equal(host(P), host(jbatch.one_hot_personalizations(gj, seeds)))
    assert P.dtype == torch.float64 and tuple(P.shape) == (4, gt.n)
    assert tuple(tbatch.one_hot_personalizations(gt, []).shape) == (0, gt.n)
    assert tbatch.one_hot_personalizations(gt, [1], dtype=torch.float32).dtype == torch.float32
    outside = [gt.n, -1, 2]  # ids outside [0, n) give zero rows, as jax.nn.one_hot
    np.testing.assert_array_equal(host(tbatch.one_hot_personalizations(gt, outside)),
                                  host(jbatch.one_hot_personalizations(gj, outside)))


def test_batch_stats_and_max_iter():
    gj, gt = graphs("web")
    seeds = _seeds(gj, 3)
    rj = jbatch.ita_batch(gj, jnp.asarray(host(jbatch.one_hot_personalizations(gj, seeds))),
                          max_iter=4)
    rt = tbatch.ita_batch(gt, tbatch.one_hot_personalizations(gt, seeds), max_iter=4)
    assert (rt.iterations, rt.converged) == (rj.iterations, rj.converged) == (4, False)
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)
    st = rt.stats()
    assert st["method"] == "ita_batch[dense]" and st["batch"] == 3 and st["iterations"] == 4
