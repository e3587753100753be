"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips on a machine without a card.  The file
imports no JAX (the GPU machine has none) and needs no conftest; run it
there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The plain versions are themselves held against the JAX reference on the
CPU (tests/test_torch_kernels.py, tests/test_torch_flash_attention.py).
Tolerances, relative and absolute, as in the reference's kernel tests:
1e-12 in float64 and 1e-5 in float32 for the ELL kernels; 2e-5 in float32
and an rtol of 2e-2 in bfloat16 for attention, whose plain versions run on
the CPU here (no TF32 question arises there).  bf16's atol is a fiftieth
of the output's median magnitude, not the reference's 2e-2, which is
larger than a decode output at S = 32,768.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ita, ita_batch, one_hot_personalizations, run_ita_loop
from repro_torch.graph import web_graph
from repro_torch.kernels import flash_attention as fa
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


ATTN_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BF16_ATOL_OF_MEDIAN = 0.02


def _attn_inputs(q_shape, kv_shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in (q_shape, kv_shape, kv_shape)]


def _close(out, ref, dtype):
    # bf16's atol follows the output's scale, as in chip_smoke.py: the
    # reference's 2e-2 was set at S <= 512 and would pass a wrong kernel at
    # S = 32,768, where outputs are ~sqrt(e / S) = 0.009
    ref = ref.float()
    rtol = ATTN_RTOL[dtype]
    atol = 2e-5 if dtype == torch.float32 else BF16_ATOL_OF_MEDIAN * float(ref.abs().median())
    torch.testing.assert_close(out.cpu().float(), ref, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hk,S,D,block_s", [
    (1, 4, 4, 256, 64, None),     # MHA
    (2, 8, 2, 512, 64, 256),      # GQA 4:1
    (1, 8, 1, 512, 128, 128),     # MQA
    (2, 16, 16, 128, 64, None),   # qwen-ish MHA
    (3, 48, 1, 1000, 128, None),  # granite-34b heads, ragged S
    (2, 32, 8, 77, 128, 64),      # minitron-8b heads, S under one tile
    (1, 96, 1, 300, 64, None),    # group above one 64-row tile
    (1, 48, 1, 32768, 128, None),  # B * Hk = 1 at decode_32k's S
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_matches_plain(cuda_device, B, Hq, Hk, S, D, block_s, dtype):
    q, k, v = _attn_inputs((B, Hq, D), (B, Hk, S, D), dtype, B * Hq + S)
    qd, kd, vd = (t.to(cuda_device) for t in (q, k, v))
    before = fa.LAUNCHES["flash_decode"]
    out = fa.flash_decode(qd, kd, vd, block_s=block_s)
    again = fa.attention_decode(qd, kd, vd, block_s=block_s)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_decode"] == before + 4  # split + combine, twice
    assert out.dtype == dtype and out.shape == (B, Hq, D)
    assert torch.equal(out, again)  # fixed-order combine: bitwise repeat
    _close(out, fa.decode_ref(q, k, v), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hk,T,S,D", [
    (1, 4, 4, 256, 256, 64),
    (2, 8, 2, 256, 256, 64),
    (1, 4, 1, 512, 512, 128),
    (1, 6, 2, 100, 100, 64),     # ragged T = S
    (1, 4, 1, 130, 200, 128),    # ragged, S > T
    (2, 2, 1, 200, 70, 64),      # S < T: late rows see every key
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_prefill_matches_plain(cuda_device, B, Hq, Hk, T, S, D, dtype):
    q, k, v = _attn_inputs((B, Hq, T, D), (B, Hk, S, D), dtype, T + D)
    qd, kd, vd = (t.to(cuda_device) for t in (q, k, v))
    before = fa.LAUNCHES["flash_prefill_causal"]
    out = fa.attention_prefill_causal(qd, kd, vd)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_prefill_causal"] == before + 1
    assert out.dtype == dtype and out.shape == (B, Hq, T, D)
    _close(out, fa.prefill_causal_ref(q, k, v), dtype)


@pytest.mark.gpu
def test_cuda_flash_prefill_is_causal(cuda_device):
    q, k, v = (t.to(cuda_device) for t in _attn_inputs((1, 2, 200, 64), (1, 2, 200, 64),
                                                       torch.float32, 7))
    o1 = fa.flash_prefill_causal(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:], v2[:, :, 100:] = 0.0, 0.0
    o2 = fa.flash_prefill_causal(q, k2, v2)
    assert torch.equal(o1[:, :, :100], o2[:, :, :100])


@pytest.mark.gpu
def test_cuda_flash_wrappers_reject_bad_inputs(cuda_device):
    q = torch.zeros((1, 4, 64), device=cuda_device)
    kv = torch.zeros((1, 2, 64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="k on"):
        fa.flash_decode(q, kv.cpu(), kv)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_decode(q[..., :32].contiguous(), kv[..., :32].contiguous(),
                        kv[..., :32].contiguous())
    with pytest.raises(TypeError):
        fa.flash_decode(q.half(), kv.half(), kv.half())
