"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips on a machine without a card.  The file
imports no JAX (the GPU machine has none) and needs no conftest; run it
there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The plain versions are themselves held against the JAX reference on the
CPU (tests/test_torch_kernels.py).  Tolerances: 1e-12 in float64 and 1e-5
in float32, relative and absolute, as in the reference's kernel tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ita, ita_batch, one_hot_personalizations, run_ita_loop
from repro_torch.graph import web_graph
from repro_torch.kernels.spmv_ell import kernel as tkernel
from repro_torch.kernels.spmv_ell import ops as tops
from repro_torch.kernels.spmv_ell import ref as tref

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip on a machine without a card.

    Decided when the test runs, never at import: every xdist worker must
    collect the same tests.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with pytest -m gpu")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 16, 32, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_plain(cuda_device, k, dtype):
    gen = torch.Generator(device="cpu").manual_seed(k)
    n, rows, B = 50_000, 3001, 16
    W = torch.rand((B, n + 1), generator=gen, dtype=dtype)
    W[:, n] = 0
    idx = torch.randint(0, n + 1, (rows, k), generator=gen, dtype=torch.int32)
    Wd, idxd = W.to(cuda_device), idx.to(cuda_device)
    before = dict(tkernel.LAUNCHES)
    single = tkernel.spmv_ell_bucket(Wd[0].contiguous(), idxd)
    batch = tkernel.spmv_ell_bucket_batch(Wd, idxd)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["spmv_ell_bucket"] == before["spmv_ell_bucket"] + 1
    assert tkernel.LAUNCHES["spmv_ell_bucket_batch"] == before["spmv_ell_bucket_batch"] + 1
    tol = TOL[dtype]
    torch.testing.assert_close(single.cpu(), tref.spmv_ell_bucket_ref(W[0], idx),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(batch.cpu(), tref.spmv_ell_bucket_batch_ref(W, idx),
                               rtol=tol, atol=tol)
    for b in range(B):
        assert torch.equal(batch[b], tkernel.spmv_ell_bucket(Wd[b].contiguous(), idxd))


@pytest.mark.gpu
def test_cuda_wrapper_rejects_mixed_devices(cuda_device):
    w = torch.zeros(11, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="src_idx on"):
        tkernel.spmv_ell_bucket(w, torch.zeros((4, 8), dtype=torch.int32))


@pytest.mark.gpu
def test_cuda_push_matches_plain_push(cuda_device):
    g_cpu = web_graph(3000, 60000, gamma_in=1.6, seed=4, device="cpu")
    g_gpu = web_graph(3000, 60000, gamma_in=1.6, seed=4, device=cuda_device)
    push_cpu = tops.prepare_push(g_cpu.ell())
    push_gpu = tops.prepare_push(g_gpu.ell())
    assert len(push_gpu.ovf_levels) >= 2
    W = torch.from_numpy(np.random.default_rng(5).random((4, g_cpu.n)))
    Y = tops.spmv_ell_batch(push_gpu, W.to(cuda_device))
    torch.testing.assert_close(Y.cpu(), tops.spmv_ell_batch(push_cpu, W),
                               rtol=1e-12, atol=1e-12)
    for b in range(W.shape[0]):
        assert torch.equal(Y[b], tops.spmv_ell(push_gpu, W[b].to(cuda_device)))


@pytest.mark.gpu
def test_cuda_solvers_match_cpu_and_batch_rows(cuda_device):
    g_cpu = web_graph(1500, 12000, dangling_frac=0.15, seed=1, device="cpu")
    g_gpu = web_graph(1500, 12000, dangling_frac=0.15, seed=1, device=cuda_device)
    for impl in ("ell", "dense"):
        r_cpu, r_gpu = ita(g_cpu, step_impl=impl), ita(g_gpu, step_impl=impl)
        assert r_gpu.pi.device.type == "cuda"
        assert (r_gpu.iterations, r_gpu.ops) == (r_cpu.iterations, r_cpu.ops)
        torch.testing.assert_close(r_gpu.pi.cpu(), r_cpu.pi, rtol=0, atol=1e-12)
    seeds = [0, 17, 400]
    P = one_hot_personalizations(g_gpu, seeds)
    _, (PiBar, H) = ita_batch(g_gpu, P, step_impl="ell", return_state=True)
    ctx = tops.prepare_push(g_gpu.ell())
    for b in range(len(seeds)):
        h0 = P[b] * g_gpu.n
        h, pi_bar, *_ = run_ita_loop(g_gpu, h0, torch.zeros_like(h0), c=0.85,
                                     xi=1e-10, max_iter=10_000, impl="ell", ctx=ctx)
        assert torch.equal(PiBar[b] + H[b], pi_bar + h)
