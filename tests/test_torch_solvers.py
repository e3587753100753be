"""Port parity: ITA, the power method and their oracles, on dense and ell.

The same graphs (numpy-built from one seed, handed over array for array)
go through ``repro.core`` and ``repro_torch.core`` on the CPU.  Contract:
π within 1e-12 (float64), iteration counts equal, Formula-15 ``ops``
equal.  The JAX ``ell`` path runs its Pallas kernel in interpret mode, as
the reference's own tests run it.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import host, port_graph

from repro.core import api as japi
from repro.core import backends as jbackends
from repro.core.ita import ita as j_ita
from repro.core.ita import ita_fixed_point as j_ita_fixed_point
from repro.core.ita import ita_step as j_ita_step
from repro.core.ita import ita_traced as j_ita_traced
from repro.core import metrics as jmetrics
from repro.core import power as jpower
from repro.core import propagate as jprop
from repro.graph import generators as jgen
from repro.graph import structure as jstruct
from repro_torch.core import api as tapi
from repro_torch.core import backends as tbackends
from repro_torch.core.ita import ita as t_ita
from repro_torch.core.ita import ita_fixed_point as t_ita_fixed_point
from repro_torch.core.ita import ita_step as t_ita_step
from repro_torch.core.ita import ita_traced as t_ita_traced
from repro_torch.core import metrics as tmetrics
from repro_torch.core import power as tpower
from repro_torch.core import propagate as tprop

ATOL = 1e-12


def _special():
    # self-loops, a dangling sink, an isolated vertex, an unreferenced
    # source and a row above 128 in-degree
    src = [0, 0, 1, 2, 2, 3, 4, 5] + list(range(6, 206))
    dst = [0, 1, 2, 3, 1, 4, 4, 1] + [206] * 200
    return jstruct.graph_from_edges(np.array(src), np.array(dst), 209)


GRAPHS = {
    "web": lambda: jgen.web_graph(1500, 12000, dangling_frac=0.15, seed=1),
    "google": lambda: jgen.paper_dataset("web-Google", scale=0.002, seed=0),
    "dag": lambda: jgen.random_dag(600, 3000, seed=3),
    "er": lambda: jgen.erdos_renyi(500, 3000, seed=2),
    "special": _special,
}
ELL_GRAPHS = ["web", "google", "special"]
CASES = [(g, "dense") for g in sorted(GRAPHS)] + [(g, "ell") for g in ELL_GRAPHS]


@functools.lru_cache(maxsize=None)
def graphs(name):
    gj = GRAPHS[name]()
    return gj, port_graph(gj)


@functools.lru_cache(maxsize=None)
def ref_ita(name, impl):
    return j_ita(graphs(name)[0], step_impl=impl)


def test_special_graph_has_every_special_vertex():
    gj, gt = graphs("special")
    assert gt.n_dangling > 0 and int(gt.unreferenced_mask.sum()) > 0
    assert int(gt.in_deg.max()) > 128
    assert bool(((gt.out_deg == 0) & (gt.in_deg == 0)).any())  # isolated


@pytest.mark.parametrize("graph,impl", CASES)
def test_ita_matches_reference(graph, impl):
    gj, gt = graphs(graph)
    rj = ref_ita(graph, impl)
    rt = t_ita(gt, step_impl=impl)
    assert rt.pi.dtype == torch.float64 and rt.pi.device.type == "cpu"
    assert (rt.iterations, rt.ops, rt.converged) == (rj.iterations, rj.ops, rj.converged)
    assert rt.method == rj.method
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)


@pytest.mark.parametrize("graph,impl", [("web", "dense"), ("web", "ell"), ("dag", "dense")])
def test_power_method_matches_reference(graph, impl):
    gj, gt = graphs(graph)
    rj = jpower.power_method(gj, step_impl=impl)
    rt = tpower.power_method(gt, step_impl=impl)
    assert (rt.iterations, rt.ops, rt.converged) == (rj.iterations, rj.ops, rj.converged)
    assert rt.method == rj.method
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rt.residual, rj.residual, rtol=0, atol=1e-14)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_ita_agrees_with_power_and_neumann(graph):
    gj, gt = graphs(graph)
    pi_ita = t_ita(gt, xi=1e-14).pi
    pi_ref = tapi.reference_pagerank(gt)
    np.testing.assert_allclose(host(pi_ref), host(japi.reference_pagerank(gj)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(host(pi_ita), host(pi_ref), rtol=0, atol=1e-10)
    pi_fp = t_ita_fixed_point(gt)
    np.testing.assert_allclose(host(pi_fp), host(j_ita_fixed_point(gj)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "ell"])
def test_ita_personalized_matches_reference(impl):
    gj, gt = graphs("web")
    p = np.random.default_rng(7).random(gj.n)
    p /= p.sum()
    rj = j_ita(gj, p=jnp.asarray(p), step_impl=impl)
    rt = t_ita(gt, p=torch.from_numpy(p), step_impl=impl)
    assert (rt.iterations, rt.ops) == (rj.iterations, rj.ops)
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)


@pytest.mark.parametrize("max_iter", [1, 3, 20])
def test_ita_max_iter_cut_matches_reference(max_iter):
    gj, gt = graphs("google")
    rj = j_ita(gj, max_iter=max_iter)
    rt = t_ita(gt, max_iter=max_iter)
    assert (rt.iterations, rt.ops, rt.converged) == (rj.iterations, rj.ops, rj.converged)
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)


def test_ita_float32_matches_reference():
    gj, gt = graphs("google")
    rj = j_ita(gj, dtype=jnp.float32, xi=1e-6)
    rt = t_ita(gt, dtype=torch.float32, xi=1e-6)
    assert rt.pi.dtype == torch.float32
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["dense", "ell"])
def test_ita_traced_matches_reference(impl):
    gj, gt = graphs("web")
    pi_true_j = japi.reference_pagerank(gj)
    rj = j_ita_traced(gj, step_impl=impl, pi_true=pi_true_j)
    rt = t_ita_traced(gt, step_impl=impl,
                         pi_true=torch.from_numpy(np.array(host(pi_true_j))))
    assert rt.iterations == rj.iterations
    assert rt.active_history == rj.active_history
    assert rt.ops_history == rj.ops_history and rt.ops == rj.ops
    np.testing.assert_allclose(rt.res_history, rj.res_history, rtol=0, atol=ATOL)
    np.testing.assert_allclose(rt.err_history, rj.err_history, rtol=1e-8, atol=ATOL)
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)
    # the traced loop is the fast loop, instrumented
    fast = t_ita(gt, step_impl=impl)
    assert fast.ops == rt.ops


def test_power_method_traced_matches_reference():
    gj, gt = graphs("dag")
    rj = jpower.power_method_traced(gj)
    rt = tpower.power_method_traced(gt)
    assert rt.iterations == rj.iterations and rt.ops == rj.ops
    np.testing.assert_allclose(rt.res_history, rj.res_history, rtol=0, atol=ATOL)
    np.testing.assert_allclose(host(rt.pi), host(rj.pi), rtol=0, atol=ATOL)


def test_ita_step_dense_matches_reference():
    gj, gt = graphs("special")
    h_j = jnp.ones(gj.n)
    inv_j, nd_j = gj.inv_out_deg(jnp.float64), jnp.logical_not(gj.dangling_mask)
    h_t = torch.ones(gt.n, dtype=torch.float64)
    inv_t, nd_t = gt.inv_out_deg(torch.float64), torch.logical_not(gt.dangling_mask)
    out_j = j_ita_step(gj, h_j, jnp.zeros_like(h_j), 0.85, 1e-10, inv_j, nd_j)
    out_t = t_ita_step(gt, h_t, torch.zeros_like(h_t), 0.85, 1e-10, inv_t, nd_t)
    np.testing.assert_allclose(host(out_t[0]), host(out_j[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(host(out_t[1]), host(out_j[1]), rtol=0, atol=ATOL)
    assert int(out_t[2]) == int(out_j[2]) and float(out_t[3]) == float(out_j[3])


def test_propagate_and_metrics_match_reference():
    gj, gt = graphs("web")
    rng = np.random.default_rng(11)
    x, y = rng.random(gj.n), rng.random(gj.n)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    yj, yt = jnp.asarray(y), torch.from_numpy(y)
    np.testing.assert_allclose(host(tprop.spmv_p(gt, xt)), host(jprop.spmv_p(gj, xj)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(host(tprop.push_weighted(gt, xt)),
                               host(jprop.push_weighted(gj, xj)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(tprop.dangling_mass(gt, xt)),
                               float(jprop.dangling_mass(gj, xj)), rtol=1e-14)
    for name in ("res_l2", "l1_diff", "err_max_rel"):
        np.testing.assert_allclose(float(getattr(tmetrics, name)(xt, yt)),
                                   float(getattr(jmetrics, name)(xj, yj)), rtol=1e-13)
    y[::7] = 0.0  # zero reference entries contribute absolute error
    np.testing.assert_allclose(
        float(tmetrics.err_max_rel(xt, torch.from_numpy(y))),
        float(jmetrics.err_max_rel(xj, jnp.asarray(y))), rtol=1e-13)


@pytest.mark.parametrize("platform,expected", [("cpu", "dense"), ("cuda", "ell")])
def test_auto_backend_per_platform(platform, expected):
    name, reason = tbackends.choose_backend({"m": 5_000_000, "platform": platform})
    assert name == expected and f"platform={platform}" in reason
    assert tbackends.resolve_step_impl("auto", platform=platform) == expected
    assert tbackends.resolve_step_impl(None, platform=platform) == expected


@pytest.mark.parametrize("name", ["dense", "ell"])
@pytest.mark.parametrize("stats", [{"m": 1000, "platform": "cpu"},
                                   {"m": 5_059_219, "platform": "cuda"},
                                   None])
def test_declared_costs_and_capabilities_match_reference(name, stats):
    # the port's "cuda" platform takes the reference's "tpu" branch
    tb, jb = tbackends.get_step_impl(name), jbackends.get_step_impl(name)
    platform = (stats or {}).get("platform") or tbackends.default_platform()
    jstats = dict(stats or {}, platform="tpu" if platform == "cuda" else platform)
    assert tb.cost(stats) == jb.cost(jstats)
    cuda_stats = dict(stats or {}, platform="cuda")
    assert tb.cost(cuda_stats) == jb.cost(dict(cuda_stats, platform="tpu"))
    # the port declares the reference's batched flag and dtypes, nothing more
    tc, jc = tb.capabilities(), jb.capabilities()
    assert (tc.batched, tc.dtypes) == (jc.batched, jc.dtypes)
    assert [f.name for f in dataclasses.fields(tc)] == ["batched", "dtypes"]


def test_registry_contract():
    assert tbackends.available_step_impls() == ["dense", "ell"]
    with pytest.raises(KeyError, match="unknown step_impl"):
        tbackends.get_step_impl("frontier")
    with pytest.raises(KeyError):
        tbackends.resolve_step_impl("nope")
    assert tbackends.resolve_step_impl("ell") == "ell"
    name, reason = tbackends.choose_backend({"m": 10, "platform": "cuda"},
                                            require=("batched",))
    assert name == "ell" and "require=['batched']" in reason
    assert tbackends.BackendCapabilities(batched=False).summary() == "none"
