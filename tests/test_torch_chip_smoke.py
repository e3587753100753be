"""The parts of ``chip_smoke.py`` that a CPU can check.

The script itself needs a card; here it must refuse to run and print no
result, and its bound arithmetic and per-launch operands are checked on a
small graph.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.backends import get_step_impl
from repro_torch.graph import web_graph

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card contract is not observable")
    proc = subprocess.run([sys.executable, str(SCRIPT)], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


@pytest.fixture(scope="module")
def push():
    g = web_graph(300, 30000, gamma_in=1.6, seed=4, device="cpu")
    return get_step_impl("ell").prepare(g)


@pytest.mark.parametrize("batch", [None, 3])
def test_push_inputs_follow_the_launch_chain(smoke, push, batch):
    pairs = smoke.push_inputs(push, torch.float64, torch.device("cpu"),
                              torch.Generator().manual_seed(0), batch=batch)
    assert len(pairs) == len(push.ell.buckets) + len(push.ovf_levels)
    lengths = [w.shape[-1] for w, _ in pairs]
    nb = len(push.ell.buckets)
    assert lengths[: nb + 1] == [push.n + 1] * (nb + 1)
    for i, level in enumerate(push.ovf_levels[:-1]):
        assert lengths[nb + 1 + i] == level.shape[0] + 1  # the partials of the level before
    for w, idx in pairs:
        assert bool((w[..., -1] == 0).all())  # the sentinel slot
        assert int(idx.max()) <= w.shape[-1] - 1
        if batch is not None:
            assert w.shape[0] == batch


def test_bound_counts_each_input_once(smoke):
    w = torch.zeros(11, dtype=torch.float64)
    idx_a = torch.full((4, 8), 10, dtype=torch.int32)
    idx_a[:, :3] = 1  # 12 real gathers, the rest sentinel
    idx_b = torch.full((2, 32), 10, dtype=torch.int32)
    ms, by, nbytes, ops = smoke.bound([(w, idx_a), (w, idx_b)], torch.float64, batch=1)
    # indices once each, outputs once each, the shared operand once
    assert nbytes == (4 * 8 + 2 * 32) * 4 + (4 + 2) * 8 + 11 * 8
    assert ops == 12 and by == "bytes"
    assert ms == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3)
    _, _, nbytes_b, ops_b = smoke.bound([(w[None].repeat(3, 1), idx_a)], torch.float64,
                                        batch=3)
    assert nbytes_b == 4 * 8 * 4 + 4 * 3 * 8 + 3 * 11 * 8 and ops_b == 36


@pytest.mark.parametrize("name,B,Hq,Hk,D", [
    ("granite-34b", 128, 48, 1, 128), ("minitron-8b", 16, 32, 8, 128),
    ("qwen1.5-0.5b", 16, 16, 16, 64)])
def test_decode_shapes_hold_2_15_gb_of_bf16_kv(smoke, name, B, Hq, Hk, D):
    assert (name, B, Hq, Hk, D) in smoke.DECODE_SHAPES
    kv_bytes = 2 * B * Hk * smoke.DECODE_S * D * 2
    assert kv_bytes == 2**31
    ms, by, nbytes, flops = smoke.attention_bound(B, Hq, Hk, 1, smoke.DECODE_S, D,
                                                  torch.bfloat16, causal=False)
    assert nbytes == kv_bytes + 2 * (2 * B * Hq * D)  # q read, output written
    assert flops == 4 * B * Hq * D * smoke.DECODE_S   # QK and PV
    assert by == "bytes" and ms == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3)


def test_attention_bounds_at_granite_width(smoke):
    f32, bf16 = torch.float32, torch.bfloat16
    ms, by, _, flops = smoke.attention_bound(128, 48, 1, 1, 32_768, 128, bf16, False)
    assert (round(ms, 3), by) == (0.642, "bytes")
    assert flops == 103_079_215_104
    ms, by, nbytes, _ = smoke.attention_bound(128, 48, 1, 1, 32_768, 128, f32, False)
    assert (round(ms, 3), by) == (1.538, "operations")  # fp32 CUDA cores, not bytes
    assert nbytes / smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(1.284, abs=1e-3)
    ms, by, _, flops = smoke.attention_bound(1, 48, 1, 4096, 4096, 128, bf16, True)
    assert flops == 4 * 48 * 128 * 4096 * 4097 // 2 == 206_208_761_856
    assert (round(ms, 4), by) == (0.2085, "operations")
    ms, by, _, _ = smoke.attention_bound(1, 48, 1, 4096, 4096, 128, f32, True)
    assert (round(ms, 2), by) == (3.08, "operations")


def test_causal_bound_counts_kept_pairs_only(smoke):
    # T = 5 queries on S = 3 keys keep 1 + 2 + 3 + 3 + 3 pairs
    _, _, _, flops = smoke.attention_bound(1, 1, 1, 5, 3, 64, torch.float32, True)
    assert flops == 4 * 64 * 12
    _, _, _, flops = smoke.attention_bound(1, 1, 1, 3, 5, 64, torch.float32, True)
    assert flops == 4 * 64 * 6


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_attention_launch_expectation(smoke, kind):
    want = smoke.ATTN_LAUNCHES[kind]
    # decode: the split pass and the combine; prefill: one launch
    assert want == ({"flash_decode": 2, "flash_prefill_causal": 0} if kind == "decode"
                    else {"flash_decode": 0, "flash_prefill_causal": 1})
    from repro_torch.kernels import attention_decode, attention_prefill_causal
    fn = attention_decode if kind == "decode" else attention_prefill_causal
    q_shape = (1, 4, 64) if kind == "decode" else (1, 4, 8, 64)
    q, k = torch.ones(q_shape), torch.ones((1, 2, 8, 64))
    out, n, n_ell = smoke.counted_attention(lambda: fn(q, k, k))
    # on the CPU the plain version runs: no kernel launches anywhere
    assert out.shape == q_shape and not any(n.values()) and not any(n_ell.values())
    assert set(n) == set(want)


def test_bf16_atol_follows_the_output_scale(smoke):
    ref = torch.full((4, 8), 0.01, dtype=torch.bfloat16)
    rtol, atol = smoke.attention_tolerance(ref)
    assert rtol == 2e-2 and atol == pytest.approx(0.02 * float(ref.float()[0, 0]))
    assert smoke.attention_tolerance(torch.full((4, 8), 0.01)) == (2e-5, 2e-5)
    # float32's fixed 2e-5 is not well under outputs of 1e-4
    with pytest.raises(RuntimeError, match="median"):
        smoke.attention_tolerance(torch.full((4, 8), 1e-4))


def _attention_f64(q4, k, v, causal):
    from repro_torch.kernels.flash_attention import repeat_kv
    group, (T, S) = q4.shape[1] // k.shape[1], (q4.shape[2], k.shape[2])
    s = q4.double() @ repeat_kv(k.double(), group).transpose(-1, -2) / q4.shape[-1] ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones((T, S), dtype=torch.bool).tril(), float("-inf"))
    return torch.softmax(s, dim=-1) @ repeat_kv(v.double(), group)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_attention_tolerance_passes_rounding_and_rejects_faults(smoke, kind, dtype):
    from repro_torch.kernels.flash_attention import decode_ref, prefill_causal_ref
    q_shape, kv_shape = (((2, 8, 64), (2, 2, 4096, 64)) if kind == "decode"
                         else ((1, 4, 256, 64), (1, 1, 256, 64)))
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen).to(dtype) for s in (q_shape, kv_shape, kv_shape))
    if kind == "decode":
        ref, sound = decode_ref(q, k, v), _attention_f64(q[:, :, None], k, v, False)[:, :, 0]
    else:
        ref, sound = prefill_causal_ref(q, k, v), _attention_f64(q, k, v, True)
    rtol, atol = smoke.attention_tolerance(ref)
    # a sound result: the same function in float64, rounded once to the dtype
    assert smoke.tolerance_ratio(sound.to(dtype), ref, rtol, atol)[1] <= 1
    faults = smoke.attention_faults(kind, q, k, v, ref, keys_per_split=1024)
    assert len(faults) == 3
    for name, bad in faults.items():
        assert bad.shape == ref.shape and bad.dtype == dtype, name
        assert smoke.tolerance_ratio(bad, ref, rtol, atol)[1] > 1, name
