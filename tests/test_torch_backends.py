"""Port parity: the backend layer's contracts (mirrors tests/test_backends.py).

Every registered ``step_impl`` of the port (``dense``, ``ell``) is
exchangeable: each push equals the reference's dense segment sum, and
every solve on every backend equals the reference's power method and the
Neumann oracle, on graphs with the paper's special vertices (dangling,
unreferenced, self-loops).  Graph generator invariants from
tests/test_graph.py are mirrored at the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import host, port_graph

from repro.core.ita import ita_step as j_ita_step
from repro.core.power import power_method as j_power_method
from repro.graph import generators as jgen
from repro.graph import structure as jstruct
from repro_torch.core import backends as tbackends
from repro_torch.core.batch import (
    ita_batch,
    one_hot_personalizations,
    power_method_batch,
)
from repro_torch.core.ita import ita, ita_fixed_point, ita_traced
from repro_torch.core.power import power_method
from repro_torch.core.propagate import segment_sum_dst
from repro_torch.graph import generators as tgen
from repro_torch.graph import structure as tstruct

IMPLS = ["dense", "ell"]


def _special_vertex_graph():
    """Dangling (3), unreferenced (0), self-loops (2, 4), a normal core."""
    src = np.array([0, 0, 1, 2, 2, 4, 5, 5, 1])
    dst = np.array([1, 2, 3, 2, 5, 4, 1, 4, 5])
    return jstruct.graph_from_edges(src, dst, 6)


GRAPHS = {
    "special": _special_vertex_graph,
    "web": lambda: jgen.web_graph(400, 3200, dangling_frac=0.25, seed=17),
    "unref": lambda: jgen.web_graph(300, 2100, dangling_frac=0.1, unref_boost=0.4,
                                    seed=18),
}


def _ref_power(gj, p=None):
    return host(j_power_method(gj, p=p, tol=1e-14, max_iter=500).pi)


class TestRegistry:
    def test_expected_backends_registered(self):
        assert set(tbackends.STEP_IMPLS) == set(IMPLS)

    def test_unknown_impl_raises(self):
        with pytest.raises(KeyError):
            tbackends.get_step_impl("nope")
        with pytest.raises(KeyError):
            ita(tgen.web_graph(50, 300, seed=0, device="cpu"), step_impl="nope")

    def test_register_and_use_custom_backend(self):
        @tbackends.register_step_impl("_test_double_dense")
        class _DoubleDense(tbackends.SolverBackend):
            def push(self, g, ctx, w):
                return segment_sum_dst(g, w[g.src.long()])

        try:
            gj = jgen.web_graph(100, 700, dangling_frac=0.1, seed=3)
            pi = ita(port_graph(gj), xi=1e-14, step_impl="_test_double_dense").pi
            np.testing.assert_allclose(host(pi), _ref_power(gj), rtol=0, atol=1e-11)
        finally:
            del tbackends.STEP_IMPLS["_test_double_dense"]


class TestPushContract:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_push_equals_reference_segment_sum(self, impl):
        gj = jgen.web_graph(300, 2400, dangling_frac=0.2, seed=9)
        g = port_graph(gj)
        backend = tbackends.get_step_impl(impl)
        w = np.random.default_rng(0).random(g.n)
        ref = jax.ops.segment_sum(jnp.asarray(w)[gj.src], gj.dst, num_segments=gj.n)
        out = backend.push(g, backend.prepare(g), torch.from_numpy(w))
        np.testing.assert_allclose(host(out), host(ref), rtol=0, atol=1e-12)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_push_batch_equals_rowwise_push(self, impl):
        g = tgen.web_graph(200, 1500, dangling_frac=0.15, seed=10, device="cpu")
        backend = tbackends.get_step_impl(impl)
        ctx = backend.prepare(g)
        W = torch.from_numpy(np.random.default_rng(1).random((5, g.n)))
        Y = backend.push_batch(g, ctx, W)
        for i in range(5):
            assert torch.equal(Y[i], backend.push(g, ctx, W[i]))

    @pytest.mark.parametrize("impl", IMPLS)
    def test_push_of_zeros_is_zero(self, impl):
        g = tgen.web_graph(50, 300, dangling_frac=0.1, seed=11, device="cpu")
        backend = tbackends.get_step_impl(impl)
        y = backend.push(g, backend.prepare(g), torch.zeros(g.n, dtype=torch.float64))
        assert float(y.abs().max()) == 0.0


class TestEquivalenceAcrossBackends:
    """Every backend == the reference power method == Neumann oracle, 1e-11."""

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("gname", sorted(GRAPHS))
    def test_ita_matches_power_and_oracle(self, impl, gname):
        gj = GRAPHS[gname]()
        g = port_graph(gj)
        pi = host(ita(g, xi=1e-14, step_impl=impl).pi)
        np.testing.assert_allclose(pi, _ref_power(gj), rtol=0, atol=1e-11)
        np.testing.assert_allclose(pi, host(ita_fixed_point(g, n_terms=300)),
                                   rtol=0, atol=1e-11)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_power_method_across_backends(self, impl):
        gj = GRAPHS["web"]()
        pi = power_method(port_graph(gj), tol=1e-14, max_iter=500, step_impl=impl).pi
        np.testing.assert_allclose(host(pi), _ref_power(gj), rtol=0, atol=1e-11)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_ita_step_contract(self, impl):
        """One round of any backend == one round of the reference ita_step."""
        gj = GRAPHS["web"]()
        g = port_graph(gj)
        backend = tbackends.get_step_impl(impl)
        ctx = backend.prepare(g)
        h = jnp.ones((gj.n,), jnp.float64)
        pi_bar = jnp.zeros_like(h)
        inv_j, nd_j = gj.inv_out_deg(jnp.float64), jnp.logical_not(gj.dangling_mask)
        inv_t, nd_t = g.inv_out_deg(torch.float64), torch.logical_not(g.dangling_mask)
        for _ in range(4):
            h1, pb1, na1, ops1 = j_ita_step(gj, h, pi_bar, 0.85, 1e-8, inv_j, nd_j)
            h2, pb2, na2, ops2 = tbackends.ita_step_impl(
                backend, g, ctx, torch.tensor(host(h)), torch.tensor(host(pi_bar)),
                0.85, 1e-8, inv_t, nd_t)
            np.testing.assert_allclose(host(h2), host(h1), rtol=0, atol=1e-12)
            np.testing.assert_allclose(host(pb2), host(pb1), rtol=0, atol=1e-12)
            assert int(na1) == int(na2) and float(ops1) == float(ops2)
            h, pi_bar = h1, pb1

    @pytest.mark.parametrize("impl", IMPLS)
    def test_personalized_across_backends(self, impl):
        gj = GRAPHS["web"]()
        p = np.zeros(gj.n)
        p[:5] = 0.2
        pi = ita(port_graph(gj), p=torch.from_numpy(p), xi=1e-15, step_impl=impl).pi
        np.testing.assert_allclose(host(pi), _ref_power(gj, p=jnp.asarray(p)),
                                   rtol=0, atol=1e-11)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_traced_matches_fast_path(self, impl):
        g = port_graph(GRAPHS["unref"]())
        r_fast = ita(g, xi=1e-12, step_impl=impl)
        r_traced = ita_traced(g, xi=1e-12, step_impl=impl)
        np.testing.assert_allclose(host(r_traced.pi), host(r_fast.pi), rtol=0, atol=1e-13)
        assert r_traced.active_history[-1] <= r_traced.active_history[0]


class TestBatchedPPR:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_batch_matches_sequential_ita(self, impl):
        g = tgen.web_graph(400, 3200, dangling_frac=0.2, seed=30, device="cpu")
        P = one_hot_personalizations(g, np.arange(8) * 7 % g.n)
        rb = ita_batch(g, P, xi=1e-13, step_impl=impl)
        assert rb.converged and tuple(rb.pi.shape) == (8, g.n)
        for i in range(8):
            pi_seq = ita(g, p=P[i], xi=1e-13, step_impl=impl).pi
            np.testing.assert_allclose(host(rb.pi[i]), host(pi_seq), rtol=0, atol=1e-12)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_batch_matches_sequential_power(self, impl):
        g = tgen.web_graph(300, 2400, dangling_frac=0.15, seed=31, device="cpu")
        P = one_hot_personalizations(g, np.arange(8))
        rb = power_method_batch(g, P, tol=1e-12, step_impl=impl)
        for i in range(8):
            pi_seq = power_method(g, p=P[i], tol=1e-12, step_impl=impl).pi
            np.testing.assert_allclose(host(rb.pi[i]), host(pi_seq), rtol=0, atol=1e-12)

    def test_batch_backends_agree(self):
        g = tgen.web_graph(250, 1800, dangling_frac=0.2, seed=32, device="cpu")
        P = one_hot_personalizations(g, np.arange(6))
        ref = ita_batch(g, P, xi=1e-13, step_impl="dense").pi
        out = ita_batch(g, P, xi=1e-13, step_impl="ell").pi
        np.testing.assert_allclose(host(out), host(ref), rtol=0, atol=1e-12)

    def test_batch_rows_sum_to_one(self):
        g = tgen.web_graph(200, 1400, dangling_frac=0.3, seed=34, device="cpu")
        rb = ita_batch(g, one_hot_personalizations(g, np.arange(5)), xi=1e-12)
        np.testing.assert_allclose(host(rb.pi.sum(1)), np.ones(5), rtol=0, atol=1e-10)

    def test_power_batch_general_personalizations(self):
        """Non-one-hot rows (mixed user profiles), against the reference."""
        gj = jgen.web_graph(200, 1500, dangling_frac=0.1, seed=36)
        g = port_graph(gj)
        P = np.random.default_rng(0).random((8, g.n))
        P /= P.sum(axis=1, keepdims=True)
        rb = power_method_batch(g, torch.from_numpy(P), tol=1e-12)
        for i in range(8):
            pi_ref = host(j_power_method(gj, p=jnp.asarray(P[i]), tol=1e-12).pi)
            np.testing.assert_allclose(host(rb.pi[i]), pi_ref, rtol=0, atol=1e-12)


class TestEllCache:
    def test_graph_ell_is_cached(self):
        g = tgen.web_graph(200, 1500, dangling_frac=0.1, seed=40, device="cpu")
        assert g.ell() is g.ell()
        assert g.ell(widths=(4, 16)) is g.ell(widths=(16, 4))  # order-insensitive
        assert g.ell() is not g.ell(widths=(4, 16))

    def test_cache_used_by_backend(self):
        g = tgen.web_graph(150, 900, dangling_frac=0.1, seed=41, device="cpu")
        assert tbackends.get_step_impl("ell").prepare(g).ell is g.ell()


# ---------------------------------------------------------------------------
# generator invariants (mirrors tests/test_graph.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gen,kw", [
    ("web_graph", dict(dangling_frac=0.2)),
    ("erdos_renyi", {}),
    ("random_dag", {}),
])
def test_generators_valid(gen, kw):
    g = getattr(tgen, gen)(500, 3000, seed=7, device="cpu", **kw)
    tstruct.validate_graph(g)
    assert g.n == 500 and 0 < g.m <= 3000


def test_web_graph_dangling_fraction():
    g = tgen.web_graph(4000, 30000, dangling_frac=0.25, seed=3, device="cpu")
    nd = g.n_dangling
    assert int(0.25 * 4000) <= nd <= int(0.30 * 4000)


def test_dag_is_acyclic():
    g = tgen.random_dag(300, 2000, seed=11, device="cpu")
    assert bool((g.src < g.dst).all())


def test_paper_dataset_stats_match_table3():
    g = tgen.paper_dataset("web-Google", scale=0.02, seed=0, device="cpu")
    s = g.stats()
    target = 136_259 / 875_713
    assert abs(s["nd"] / s["n"] - target) / target < 0.3
    tstruct.validate_graph(g)


def test_csr_roundtrip():
    g = tgen.web_graph(200, 1500, seed=5, device="cpu")
    off, idx = tstruct.csr_from_graph(g, by="src")
    assert off[-1] == g.m
    out_deg = np.diff(off)
    assert np.array_equal(out_deg, host(g.out_deg))
    src_csr = np.repeat(np.arange(g.n), out_deg)
    edges_csr = set(zip(src_csr.tolist(), idx.tolist()))
    edges_coo = set(zip(host(g.src).tolist(), host(g.dst).tolist()))
    assert edges_csr == edges_coo
