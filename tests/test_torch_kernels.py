"""Port parity: the ELL bucket kernels and the full-graph push built on them.

On the CPU the wrappers take the kernels' plain versions; those are held
against the Pallas kernels run as their own tests run them
(``interpret=True``).  Tolerances are the reference's
(``tests/test_kernels.py::TestSpmvEll``): 1e-12 in float64, 1e-5 in
float32.  The CUDA kernels are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import host, port_ell

from repro.core import ita_step as j_ita_step
from repro.graph import generators as jgen
from repro.kernels.spmv_ell import kernel as jkernel
from repro.kernels.spmv_ell import ops as jops
from repro.sparse import ell as jell
from repro_torch.kernels.spmv_ell import kernel as tkernel
from repro_torch.kernels.spmv_ell import ops as tops

DTYPES = {"f32": (torch.float32, np.float32, 1e-5),
          "f64": (torch.float64, np.float64, 1e-12)}


def _operand(rng, n, batch=None):
    shape = (n + 1,) if batch is None else (batch, n + 1)
    w = rng.standard_normal(shape)
    w[..., n] = 0.0  # sentinel slot
    return w


def _indices(rng, n, rows, k):
    return rng.integers(0, n + 1, size=(rows, k)).astype(np.int32)


@pytest.mark.parametrize("rows,k", [(8, 8), (300, 8), (256, 32), (100, 128),
                                    (7, 16), (33, 200), (0, 8)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bucket_plain_matches_pallas(rows, k, dt):
    tdtype, ndtype, tol = DTYPES[dt]
    rng = np.random.default_rng(rows * k + 1)
    n = 500
    w = _operand(rng, n).astype(ndtype)
    idx = _indices(rng, n, rows, k)
    out_j = host(jkernel.spmv_ell_bucket(jnp.asarray(w), jnp.asarray(idx),
                                         block_rows=64, interpret=True)) \
        if rows else np.zeros(0, ndtype)
    out_t = tkernel.spmv_ell_bucket(torch.from_numpy(w), torch.from_numpy(idx))
    assert out_t.dtype == tdtype and tuple(out_t.shape) == (rows,)
    np.testing.assert_allclose(host(out_t), out_j, rtol=tol, atol=tol)


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("rows,k", [(64, 8), (40, 32), (24, 128)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bucket_batch_plain_matches_pallas(B, rows, k, dt):
    tdtype, ndtype, tol = DTYPES[dt]
    rng = np.random.default_rng(B * rows + k)
    n = 300
    W = _operand(rng, n, batch=B).astype(ndtype)
    idx = _indices(rng, n, rows, k)
    out_j = host(jkernel.spmv_ell_bucket_batch(jnp.asarray(W), jnp.asarray(idx),
                                               block_rows=16, interpret=True))
    out_t = tkernel.spmv_ell_bucket_batch(torch.from_numpy(W), torch.from_numpy(idx))
    assert out_t.dtype == tdtype and tuple(out_t.shape) == (B, rows)
    np.testing.assert_allclose(host(out_t), out_j, rtol=tol, atol=tol)
    # the batch-row invariance the batched solvers rest on
    for b in range(B):
        single = tkernel.spmv_ell_bucket(torch.from_numpy(W[b]), torch.from_numpy(idx))
        assert torch.equal(out_t[b], single)


def test_cpu_wrappers_launch_nothing():
    tkernel.reset_launch_counts()
    rng = np.random.default_rng(0)
    w = torch.from_numpy(_operand(rng, 50))
    idx = torch.from_numpy(_indices(rng, 50, 10, 8))
    tkernel.spmv_ell_bucket(w, idx)
    tkernel.spmv_ell_bucket_batch(w[None].contiguous(), idx)
    assert tkernel.LAUNCHES == {"spmv_ell_bucket": 0, "spmv_ell_bucket_batch": 0}


@pytest.mark.parametrize("bad,err", [
    (dict(w=torch.zeros(11, dtype=torch.int64)), TypeError),
    (dict(idx=torch.zeros((4, 8), dtype=torch.int64)), TypeError),
    (dict(w=torch.zeros((2, 11), dtype=torch.float64)), ValueError),
    (dict(idx=torch.zeros(8, dtype=torch.int32)), ValueError),
    (dict(w=torch.zeros(22, dtype=torch.float64)[::2]), ValueError),
    (dict(w=torch.zeros(0, dtype=torch.float64)), ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, err):
    args = dict(w=torch.zeros(11, dtype=torch.float64),
                idx=torch.zeros((4, 8), dtype=torch.int32))
    args.update(bad)
    with pytest.raises(err):
        tkernel.spmv_ell_bucket(args["w"], args["idx"])


GRAPHS = {
    "web": lambda: jgen.web_graph(1500, 12000, dangling_frac=0.15, seed=1),
    "google": lambda: jgen.paper_dataset("web-Google", scale=0.002, seed=0),
    "er": lambda: jgen.erdos_renyi(400, 2000, seed=2),
    "dense_rows": lambda: jgen.web_graph(300, 30000, gamma_in=1.6, seed=4),
}


@pytest.fixture(scope="module")
def layouts():
    out = {}
    for name, make in GRAPHS.items():
        gj = make()
        for widths in ((8, 32, 128), (4, 16, 64)):
            ej = jell.ell_from_graph(gj, widths=widths)
            out[name, widths] = (gj, ej, tops.prepare_push(port_ell(ej)))
    return out


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("widths", [(8, 32, 128), (4, 16, 64)])
def test_spmv_ell_chunked_overflow_matches_reference(layouts, graph, widths):
    gj, ej, push = layouts[graph, widths]
    w = np.random.default_rng(1).random(gj.n)
    y_ref = host(jops.spmv_ell(ej, jnp.asarray(w), interpret=True))
    y_port = host(tops.spmv_ell(push, torch.from_numpy(w)))
    np.testing.assert_allclose(y_port, y_ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_spmv_ell_batch_matches_reference_and_rows(layouts, graph):
    gj, ej, push = layouts[graph, (8, 32, 128)]
    W = np.random.default_rng(2).random((5, gj.n))
    Y_ref = host(jops.spmv_ell_batch(ej, jnp.asarray(W), interpret=True))
    Y_port = tops.spmv_ell_batch(push, torch.from_numpy(W))
    np.testing.assert_allclose(host(Y_port), Y_ref, rtol=0, atol=1e-12)
    for b in range(W.shape[0]):
        assert torch.equal(Y_port[b], tops.spmv_ell(push, torch.from_numpy(W[b])))


def test_overflow_levels_cover_every_edge_once(layouts):
    gj, ej, push = layouts["dense_rows", (8, 32, 128)]
    ovf_src, ovf_dst = host(ej.ovf_src), host(ej.ovf_dst)
    heavy, counts = np.unique(ovf_dst, return_counts=True)
    np.testing.assert_array_equal(host(push.ovf_rows), heavy)
    lvl0 = host(push.ovf_levels[0])
    assert lvl0.shape == (int(np.sum(-(-counts // tops.OVF_CHUNK))), tops.OVF_CHUNK)
    real = lvl0[lvl0 != gj.n]
    np.testing.assert_array_equal(real, ovf_src)  # in order, each edge once
    assert len(push.ovf_levels) >= 2  # some row needs more than one chunk
    assert host(push.ovf_levels[-1]).shape[0] == heavy.size


def test_deep_overflow_levels(monkeypatch, layouts):
    # narrow chunks force several partial-sum levels on the same layout
    gj, ej, _ = layouts["dense_rows", (8, 32, 128)]
    monkeypatch.setattr(tops, "OVF_CHUNK", 4)
    push = tops.prepare_push(port_ell(ej))
    assert len(push.ovf_levels) >= 4
    w = np.random.default_rng(3).random(gj.n)
    y_ref = host(jops.spmv_ell(ej, jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(host(tops.spmv_ell(push, torch.from_numpy(w))),
                               y_ref, rtol=0, atol=1e-12)


def test_no_overflow_layout(layouts):
    gj, ej, push = layouts["er", (8, 32, 128)]
    assert host(ej.ovf_src).size == 0 and push.ovf_levels == ()
    w = np.random.default_rng(4).random(gj.n)
    np.testing.assert_allclose(
        host(tops.spmv_ell(push, torch.from_numpy(w))),
        host(jops.spmv_ell(ej, jnp.asarray(w), interpret=True)), rtol=0, atol=1e-12)


def test_prepare_push_rejects_out_of_range_index(layouts):
    _, ej, _ = layouts["er", (8, 32, 128)]
    et = port_ell(ej)
    et.buckets[0].src_idx[0, 0] = et.n + 1
    with pytest.raises(ValueError, match="outside"):
        tops.prepare_push(et)


def test_ita_step_ell_matches_reference(layouts):
    gj, ej, push = layouts["web", (8, 32, 128)]
    h = jnp.ones((gj.n,), jnp.float64)
    pi_bar = jnp.zeros_like(h)
    inv_deg = gj.inv_out_deg(jnp.float64)
    nd = jnp.logical_not(gj.dangling_mask)
    ht, pbt = torch.tensor(host(h)), torch.tensor(host(pi_bar))
    inv_t, nd_t = torch.tensor(host(inv_deg)), torch.tensor(host(nd))
    # the push tolerance (1e-12): h reaches ~80 on heavy rows, whose sums
    # the chunked overflow groups differently from a sequential segment sum
    for _ in range(5):
        h, pi_bar, na_j, _ = j_ita_step(gj, h, pi_bar, 0.85, 1e-8, inv_deg, nd)
        ht, pbt, na_t = tops.ita_step_ell(push, ht, pbt, 0.85, 1e-8, inv_t, nd_t)
        np.testing.assert_allclose(host(ht), host(h), rtol=0, atol=1e-12)
        np.testing.assert_allclose(host(pbt), host(pi_bar), rtol=0, atol=1e-12)
        assert int(na_t) == int(na_j)
        ht, pbt = torch.tensor(host(h)), torch.tensor(host(pi_bar))
