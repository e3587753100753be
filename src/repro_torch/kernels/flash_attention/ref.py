"""Plain PyTorch versions of the two flash-attention kernels.

Port of ``src/repro/kernels/flash_attention/ref.py``.  They compute in
float32 and cast to q's dtype, scaling q by ``1/sqrt(D)`` in float32
before the product, as the reference does.  These are what the kernel
wrappers compute on a CPU tensor, and what ``chip_smoke.py`` and the
card-marked tests hold the CUDA kernels against.

The reference repeats the KV heads up to Hq (``repeat_kv``) before its
products.  At granite-34b's MQA (48 query heads on one KV head) and a
32k cache that copy would take 103 GB in float32, so the versions here
view q as ``[B, Hk, group, ...]`` against K/V ``[B, Hk, S, D]``: the same
arithmetic with no copy.  ``repeat_kv`` stays, ported, for parity.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "decode_ref", "prefill_causal_ref", "repeat_kv"]

NEG_INF = -1e30  # the masked score, as in the reference kernel


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """[B, Hk, S, D] -> [B, Hk*group, S, D] by head repetition."""
    if group == 1:
        return x
    B, Hk, S, D = x.shape
    return x[:, :, None].expand(B, Hk, group, S, D).reshape(B, Hk * group, S, D)


def _softmax_rows(s: torch.Tensor) -> torch.Tensor:
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D] against K/V [B, Hk, S, D] -> [B, Hq, D] in q's dtype."""
    B, Hq, D = q.shape
    Hk = k.shape[1]
    qf = (q.float() / math.sqrt(D)).reshape(B, Hk, Hq // Hk, D)
    s = qf @ k.float().transpose(-1, -2)                     # [B, Hk, group, S]
    o = _softmax_rows(s) @ v.float()                         # [B, Hk, group, D]
    return o.reshape(B, Hq, D).to(q.dtype)


def prefill_causal_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention, q [B, Hq, T, D] against K/V [B, Hk, S, D] -> [B, Hq, T, D].

    The mask is top-left (query t sees keys s <= t), masked scores are
    ``NEG_INF``, as in the reference.
    """
    B, Hq, T, D = q.shape
    Hk, S = k.shape[1], k.shape[2]
    qf = (q.float() / math.sqrt(D)).reshape(B, Hk, Hq // Hk, T, D)
    s = qf @ k.float()[:, :, None].transpose(-1, -2)         # [B, Hk, group, T, S]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    o = _softmax_rows(s) @ v.float()[:, :, None]             # [B, Hk, group, T, D]
    return o.reshape(B, Hq, T, D).to(q.dtype)
