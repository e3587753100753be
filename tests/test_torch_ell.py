"""Port parity: the bucketed-ELL layout.

``repro_torch.sparse.ell.ell_from_graph`` must build the reference's
``row_ids``, ``src_idx`` and overflow arrays array for array, and its
plain-torch oracle must push what the reference's oracle pushes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import host, port_ell, port_graph

from repro.graph import generators as jgen
from repro.sparse import ell as jell
from repro_torch.sparse import ell as tell

GRAPHS = {
    "web": lambda: jgen.web_graph(1500, 12000, dangling_frac=0.15, seed=1),
    "google": lambda: jgen.paper_dataset("web-Google", scale=0.002, seed=0),
    "er": lambda: jgen.erdos_renyi(400, 2000, seed=2),
    "dag": lambda: jgen.random_dag(700, 4000, seed=3),
    "tiny": lambda: jgen.web_graph(64, 300, dangling_frac=0.3, seed=5),
}


def assert_ell_equal(et, ej):
    assert (et.n, et.m, et.sentinel) == (ej.n, ej.m, ej.sentinel)
    assert len(et.buckets) == len(ej.buckets)
    for bt, bj in zip(et.buckets, ej.buckets):
        assert (bt.k, bt.rows) == (bj.k, bj.rows)
        for f in ("row_ids", "src_idx"):
            a, b = host(getattr(bt, f)), host(getattr(bj, f))
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b, err_msg=f"k={bt.k} {f}")
    for f in ("ovf_src", "ovf_dst"):
        a, b = host(getattr(et, f)), host(getattr(ej, f))
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert et.fill_stats() == ej.fill_stats()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("widths,row_align", [
    ((8, 32, 128), 8), ((4, 16, 64), 8), ((16,), 8), ((8, 32, 128), 1),
    ((32, 8), 16),
])
def test_ell_from_graph_arrays_equal(graph, widths, row_align):
    gj = GRAPHS[graph]()
    et = tell.ell_from_graph(port_graph(gj), widths=widths, row_align=row_align)
    assert_ell_equal(et, jell.ell_from_graph(gj, widths=widths, row_align=row_align))


def test_graph_ell_view_matches_reference():
    gj = GRAPHS["web"]()
    assert_ell_equal(port_graph(gj).ell(), gj.ell())


def test_empty_graph_layout():
    from repro.graph import structure as jstruct
    gj = jstruct.graph_from_edges([], [], 10)
    et = tell.ell_from_graph(port_graph(gj))
    assert_ell_equal(et, jell.ell_from_graph(gj))
    out = tell.spmv_ell_ref(et, torch.ones(10, dtype=torch.float64))
    np.testing.assert_array_equal(host(out), np.zeros(10))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("widths", [(8, 32, 128), (4, 16, 64)])
def test_spmv_ell_ref_matches_reference_oracle(graph, widths):
    gj = GRAPHS[graph]()
    ej = jell.ell_from_graph(gj, widths=widths)
    w = np.random.default_rng(0).random(gj.n)
    y_ref = host(jell.spmv_ell_ref(ej, jnp.asarray(w)))
    y_coo = host(jax.ops.segment_sum(jnp.asarray(w)[gj.src], gj.dst,
                                     num_segments=gj.n))
    y_port = host(tell.spmv_ell_ref(port_ell(ej), torch.from_numpy(w)))
    np.testing.assert_allclose(y_port, y_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(y_port, y_coo, rtol=0, atol=1e-12)


def test_overflow_sits_on_few_heavy_rows():
    # the shape behind the chunked overflow push: many edges, few rows
    et = tell.ell_from_graph(port_graph(GRAPHS["web"]()))
    heavy = np.unique(host(et.ovf_dst))
    assert et.fill_stats()["overflow_edges"] > 0.05 * et.m
    assert heavy.size < 0.01 * et.n
