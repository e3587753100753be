"""Port parity: the graph container and generators.

``repro_torch.graph`` against ``repro.graph`` on the same seeds and edge
lists: the arrays must be equal, element for element.
"""
import numpy as np
import pytest
import torch
from _torch_parity import assert_graph_equal, host, port_graph

from repro.graph import generators as jgen
from repro.graph import structure as jstruct
from repro_torch.device import resolve_device
from repro_torch.graph import generators as tgen
from repro_torch.graph import structure as tstruct


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n,m,dangling_frac,unref_boost", [
    (300, 2400, 0.1, 0.0),
    (1000, 6000, 0.2, 0.1),
    (64, 64, 0.0, 0.0),
    (500, 100, 0.5, 0.0),
])
def test_web_graph_arrays_equal(seed, n, m, dangling_frac, unref_boost):
    kw = dict(dangling_frac=dangling_frac, unref_boost=unref_boost, seed=seed)
    assert_graph_equal(tgen.web_graph(n, m, device="cpu", **kw),
                       jgen.web_graph(n, m, **kw))


@pytest.mark.parametrize("gen", ["erdos_renyi", "random_dag"])
@pytest.mark.parametrize("n,m,seed", [(200, 1500, 0), (1200, 5000, 3), (50, 2000, 5)])
def test_uniform_generators_arrays_equal(gen, n, m, seed):
    assert_graph_equal(getattr(tgen, gen)(n, m, seed=seed, device="cpu"),
                       getattr(jgen, gen)(n, m, seed=seed))


@pytest.mark.parametrize("name,scale", [
    ("web-Stanford", 0.005), ("Stanford-Berkeley", 0.002),
    ("web-Google", 0.002), ("in-2004", 0.001), ("web-Google", 1e-6),
])
def test_paper_dataset_arrays_equal(name, scale):
    assert tgen.TABLE3_PRESETS == jgen.TABLE3_PRESETS
    gt = tgen.paper_dataset(name, scale=scale, seed=2, device="cpu")
    gj = jgen.paper_dataset(name, scale=scale, seed=2)
    assert_graph_equal(gt, gj)
    assert gt.stats() == gj.stats()


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("drop_self_loops", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_graph_from_edges_arrays_equal(dedup, drop_self_loops, seed):
    rng = np.random.default_rng(seed)
    n = 40
    src = rng.integers(0, n, size=300)  # duplicates and self-loops included
    dst = rng.integers(0, n, size=300)
    kw = dict(dedup=dedup, drop_self_loops=drop_self_loops)
    assert_graph_equal(tstruct.graph_from_edges(src, dst, n, device="cpu", **kw),
                       jstruct.graph_from_edges(src, dst, n, **kw))


def test_graph_from_edges_empty_and_errors():
    gt = tstruct.graph_from_edges([], [], 5, device="cpu")
    assert_graph_equal(gt, jstruct.graph_from_edges([], [], 5))
    with pytest.raises(ValueError, match="out of range"):
        tstruct.graph_from_edges([0, 5], [1, 2], 5, device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        tstruct.graph_from_edges([0, 1], [1], 5, device="cpu")


def test_graph_from_arrays_carries_reference_graph():
    gj = jgen.web_graph(400, 3000, dangling_frac=0.2, seed=4)
    gt = port_graph(gj)
    assert_graph_equal(gt, gj)
    tstruct.validate_graph(gt)


def test_validate_graph_rejects_unsorted_edges():
    gt = tstruct.graph_from_arrays([1, 0], [1, 0], [1, 1], [1, 1], 2, device="cpu")
    with pytest.raises(ValueError, match="dst-sorted"):
        tstruct.validate_graph(gt)
    bad = tstruct.graph_from_arrays([0], [1], [1, 0], [0, 0], 2, device="cpu")
    with pytest.raises(ValueError, match="degree sums"):
        tstruct.validate_graph(bad)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, np.float32),
                                          (torch.float64, np.float64)])
def test_masks_inv_deg_and_stats(dtype, jdtype):
    gj = jgen.web_graph(800, 5000, dangling_frac=0.25, seed=9)
    gt = port_graph(gj)
    np.testing.assert_array_equal(host(gt.dangling_mask), host(gj.dangling_mask))
    np.testing.assert_array_equal(host(gt.unreferenced_mask),
                                  host(gj.unreferenced_mask))
    inv_t, inv_j = host(gt.inv_out_deg(dtype)), host(gj.inv_out_deg(jdtype))
    assert inv_t.dtype == inv_j.dtype
    np.testing.assert_array_equal(inv_t, inv_j)
    assert gt.stats() == gj.stats()
    assert gt.n_dangling == int(gj.n_dangling)
    assert gt.avg_degree == gj.avg_degree


@pytest.mark.parametrize("by", ["src", "dst"])
def test_csr_from_graph_equal(by):
    gj = jgen.web_graph(600, 4000, seed=3)
    off_t, idx_t = tstruct.csr_from_graph(port_graph(gj), by=by)
    off_j, idx_j = jstruct.csr_from_graph(gj, by=by)
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(idx_t, idx_j)
    with pytest.raises(ValueError):
        tstruct.csr_from_graph(port_graph(gj), by="both")


def test_ell_view_is_cached_per_key():
    gt = tgen.web_graph(300, 2000, seed=0, device="cpu")
    assert gt.ell() is gt.ell()
    assert gt.ell() is gt.ell(widths=(128, 8, 32))
    assert gt.ell(widths=(16,)) is not gt.ell()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card contract is not observable")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tgen.web_graph(100, 400, seed=0)  # the default device is cuda
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
