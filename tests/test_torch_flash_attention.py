"""Port parity: the flash-attention entry points and their plain versions.

The same numpy-seeded inputs go through the JAX package's Pallas kernels
(``interpret=True``, as ``tests/test_kernels.py::TestFlashAttention`` runs
them) and oracles, and through the port's plain versions, its public
entry points and ``repeat_kv`` on the CPU, where the wrappers take the
plain versions.  Inputs are rounded to float32 before either side casts
them, so bfloat16 inputs are equal bit for bit; outputs are compared in
float32.  Tolerances are the reference's: 2e-5 in float32, 2e-2 in
bfloat16, relative and absolute.  The CUDA kernels are held against these
plain versions on the card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import attention_decode, attention_prefill_causal
from repro_torch.kernels import flash_attention as tfa

DTYPES = {"f32": (torch.float32, jnp.float32, 2e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(seed, q_shape, kv_shape, dtype):
    """(torch q, k, v), (jax q, k, v) from one numpy draw."""
    tdt, jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape)]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _close(out, ref, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Hq,Hk,S,D,bs", [
    (1, 4, 4, 256, 64, 128),    # MHA
    (2, 8, 2, 512, 64, 256),    # GQA 4:1
    (1, 8, 1, 512, 128, 128),   # MQA (granite-34b pattern)
    (2, 16, 16, 128, 64, 128),  # qwen-ish MHA
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_matches_pallas_and_oracle(B, Hq, Hk, S, D, bs, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(B * Hq + S, (B, Hq, D), (B, Hk, S, D), dtype)
    out = attention_decode(q, k, v)
    assert out.dtype == q.dtype and out.shape == (B, Hq, D)
    _close(out, jfa.flash_decode(jq, jk, jv, block_s=bs, interpret=True), dtype)
    _close(out, jfa.decode_ref(jq, jk, jv), dtype)
    _close(tfa.decode_ref(q, k, v), jfa.decode_ref(jq, jk, jv), dtype)
    assert torch.equal(tfa.flash_decode(q, k, v, block_s=bs), out)


@pytest.mark.parametrize("B,Hq,Hk,T,D", [
    (1, 4, 4, 256, 64),
    (2, 8, 2, 256, 64),
    (1, 4, 1, 512, 128),
])
def test_prefill_matches_pallas_and_oracle(B, Hq, Hk, T, D):
    (q, k, v), (jq, jk, jv) = _inputs(T + D, (B, Hq, T, D), (B, Hk, T, D), "f32")
    out = attention_prefill_causal(q, k, v)
    assert out.dtype == q.dtype and out.shape == (B, Hq, T, D)
    _close(out, jfa.flash_prefill_causal(jq, jk, jv, block_q=128, block_s=64,
                                         interpret=True), "f32")
    _close(out, jfa.prefill_causal_ref(jq, jk, jv), "f32")
    _close(tfa.prefill_causal_ref(q, k, v), jfa.prefill_causal_ref(jq, jk, jv), "f32")


def test_prefill_bf16_matches_pallas_and_oracle():
    B, Hq, Hk, T, D = 2, 8, 2, 128, 64
    (q, k, v), (jq, jk, jv) = _inputs(3, (B, Hq, T, D), (B, Hk, T, D), "bf16")
    out = attention_prefill_causal(q, k, v)
    assert out.dtype == torch.bfloat16
    _close(out, jfa.flash_prefill_causal(jq, jk, jv, block_q=64, block_s=64,
                                         interpret=True), "bf16")
    _close(out, jfa.prefill_causal_ref(jq, jk, jv), "bf16")


@pytest.mark.parametrize("group", [1, 4, 48])
def test_repeat_kv_matches_reference(group):
    (_, k, _), (_, jk, _) = _inputs(group, (1,), (2, 3, 5, 8), "f32")
    out = tfa.repeat_kv(k, group)
    assert out.shape == (2, 3 * group, 5, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jfa.repeat_kv(jk, group)))


@pytest.mark.parametrize("S", [1, 77, 300])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_ragged_s_matches_oracle(S, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(S, (2, 8, 64), (2, 2, S, 64), dtype)
    _close(attention_decode(q, k, v), jfa.decode_ref(jq, jk, jv), dtype)


@pytest.mark.parametrize("T,S", [(100, 100), (130, 200), (200, 70)])
def test_prefill_ragged_matches_oracle(T, S):
    (q, k, v), (jq, jk, jv) = _inputs(T * S, (1, 4, T, 64), (1, 2, S, 64), "f32")
    _close(attention_prefill_causal(q, k, v), jfa.prefill_causal_ref(jq, jk, jv), "f32")


def test_causality():
    """Changing future KV must not change past outputs."""
    (q, k, v), _ = _inputs(7, (1, 2, 128, 64), (1, 2, 128, 64), "f32")
    o1 = attention_prefill_causal(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 64:], v2[:, :, 64:] = 0.0, 0.0
    o2 = attention_prefill_causal(q, k2, v2)
    np.testing.assert_allclose(o1[:, :, :64].numpy(), o2[:, :, :64].numpy(), atol=1e-6)


def test_wrappers_reject_bad_inputs():
    q, kv = torch.zeros((1, 4, 64)), torch.zeros((1, 2, 16, 64))
    q4 = torch.zeros((1, 4, 16, 64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_decode(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_prefill_causal(q4.double(), kv.double(), kv.double())
    with pytest.raises(TypeError, match="share a dtype"):
        tfa.flash_decode(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        tfa.flash_decode(torch.zeros((1, 3, 64)), kv, kv)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        tfa.flash_prefill_causal(torch.zeros((1, 5, 16, 64)), kv, kv)
    with pytest.raises(ValueError, match="k on meta"):
        tfa.flash_decode(q, kv.to("meta"), kv)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_decode(q, kv.transpose(2, 3).contiguous().transpose(2, 3), kv)
    with pytest.raises(ValueError, match="empty"):
        tfa.flash_decode(q, kv[:, :, :0], kv[:, :, :0])
    with pytest.raises(ValueError, match="block_s"):
        tfa.flash_decode(q, kv, kv, block_s=100)
    with pytest.raises(ValueError, match="tile"):
        tfa.flash_prefill_causal(q4, kv, kv, block_q=256)


@pytest.mark.parametrize("bhk,S,block_s", [(1, 32768, None), (128, 32768, None),
                                           (256, 32768, None), (3, 77, None),
                                           (2, 1000, 128), (100_000, 64, None)])
def test_decode_splits_cover_s_and_fill_the_card(bhk, S, block_s):
    splits, per = tfa.decode_splits(bhk, S, 132, block_s)
    assert per % 64 == 0 and (splits - 1) * per < S <= splits * per  # none empty
    if block_s is None:  # every SM gets a block, even at B * Hk = 1
        assert bhk * splits >= min(132, bhk * -(-S // 64))
    if block_s is not None:
        assert per == block_s
