"""Wrappers for the hand-written flash-attention kernels (``csrc/flash_attention.cu``).

They replace the Pallas TPU kernels ``flash_decode`` and
``flash_prefill_causal`` of ``src/repro/kernels/flash_attention/kernel.py``,
with the same layouts: decode takes q ``[B, Hq, D]`` and K/V
``[B, Hk, S, D]`` to ``[B, Hq, D]``; causal prefill takes q
``[B, Hq, T, D]`` and K/V ``[B, Hk, S, D]`` to ``[B, Hq, T, D]``; query head
h reads KV head ``h // (Hq // Hk)``.  The source file states each kernel's
bound and design.  ``interpret`` has no counterpart and is gone.

A wrapper checks device, dtype (float32 or bfloat16; anything else is a
``TypeError``), shapes, the head ratio and contiguity, allocates its output
and the decode partials with ``torch.empty``, and launches on the current
stream.  A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor
launches the kernel, or raises.  ``LAUNCHES`` counts kernel launches, and
only those: decode launches twice a call (the split pass and the combine),
prefill once.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..build import load_library
from .ref import decode_ref, prefill_causal_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "TILE", "decode_splits", "flash_decode",
           "flash_prefill_causal", "reset_launch_counts"]

# kernel name -> launches since the last reset (plain integers)
LAUNCHES: dict[str, int] = {"flash_decode": 0, "flash_prefill_causal": 0}

TILE = 64              # the kernels' query-row and key tile
HEAD_DIMS = (64, 128)  # head dims the kernels are built for (the repo's LM configs)
SPLIT_BLOCKS_PER_SM = 8  # decode: aim for this many split blocks per SM

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q, k, v, part_ml, part_acc, B, Hq, Hk, S, D, splits, keys_per_split, scale,
    # device, stream
    "flash_decode_split": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # part_ml, part_acc, out, B*Hq, splits, D, device, stream
    "flash_decode_combine": [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, B, Hq, Hk, T, S, D, scale, device, stream
    "flash_prefill_causal": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
}
_FUNCS: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _func(name: str, dtype: torch.dtype):
    key = (name, dtype)
    if key not in _FUNCS:
        lib = load_library("flash_attention")
        fn = getattr(lib, f"{name}_{_DTYPES[dtype]}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _FUNCS[key] = (fn, lib.flash_attention_error_string)
    return _FUNCS[key]


def _launch(name: str, counter: str, ref: torch.Tensor, args: list) -> None:
    fn, err_str = _func(name, ref.dtype)
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    code = fn(*args, ref.device.index, stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({err_str(code).decode()})")
    LAUNCHES[counter] += 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_ndim: int) -> None:
    """Shared checks; q has ``q_ndim`` dims (3 decode, 4 prefill)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != q_ndim or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected a {q_ndim}-D q and equal 4-D k and v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, D = q.shape[0], q.shape[1], q.shape[-1]
    _, Hk, S, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on "
                         f"batch or head dim")
    if Hk < 1 or Hq % Hk:
        raise ValueError(f"query heads ({Hq}) must be a multiple of KV heads ({Hk})")
    if S < 1:
        raise ValueError("the KV sequence is empty")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.device.type == "cuda":
        if D not in HEAD_DIMS:
            raise ValueError(f"head dim {D} not built; the kernels take {HEAD_DIMS}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("q, k and v must start on a 16-byte boundary")


def decode_splits(batch_kv_heads: int, S: int, n_sms: int,
                  block_s: int | None = None) -> tuple[int, int]:
    """(splits, keys per split) of the decode kernel's S axis.

    ``block_s`` (a multiple of the 64-key tile) fixes the keys per split.
    Left as None, the splits are enough that ``B * Hk * splits`` blocks
    give each of the card's ``n_sms`` SMs about ``SPLIT_BLOCKS_PER_SM``,
    with whole tiles per split.  Every split holds at least one key.
    """
    tiles = -(-S // TILE)
    if block_s is None:
        want = -(-SPLIT_BLOCKS_PER_SM * n_sms // max(batch_kv_heads, 1))
        per_split = -(-tiles // min(max(want, 1), tiles))
    else:
        per_split = block_s // TILE
    return -(-tiles // per_split), per_split * TILE


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 block_s: int | None = None) -> torch.Tensor:
    """One query token against a KV cache: q [B, Hq, D], K/V [B, Hk, S, D] -> [B, Hq, D].

    ``block_s`` is the number of keys one block of the split pass takes
    (see :func:`decode_splits`); any S works.  Two launches: the split pass
    and the fixed-order combine, so two runs are bitwise equal.
    """
    _check(q, k, v, 3)
    if block_s is not None and (block_s <= 0 or block_s % TILE):
        raise ValueError(f"block_s={block_s}; must be a positive multiple of {TILE}")
    if q.device.type == "cpu":
        return decode_ref(q, k, v)
    B, Hq, D = q.shape
    _, Hk, S, _ = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if B * Hk > 65535:
        raise ValueError(f"B * Hk = {B * Hk} exceeds the grid's 65535")
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, keys_per_split = decode_splits(B * Hk, S, n_sms, block_s)
    # acc first: its rows of D floats keep the 16-byte alignment of the
    # kernel's float4 stores
    part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=q.device)
    part_acc, part_ml = part[: B * Hq * splits * D], part[B * Hq * splits * D:]
    _launch("flash_decode_split", "flash_decode", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), part_ml.data_ptr(),
             part_acc.data_ptr(), B, Hq, Hk, S, D, splits, keys_per_split,
             1.0 / math.sqrt(D)])
    _launch("flash_decode_combine", "flash_decode", q,
            [part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B * Hq,
             splits, D])
    return out


def flash_prefill_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         block_q: int = TILE, block_s: int = TILE) -> torch.Tensor:
    """Causal attention: q [B, Hq, T, D], K/V [B, Hk, S, D] -> [B, Hq, T, D].

    Top-left mask (query t sees keys s <= t).  ``block_q`` and ``block_s``
    name the kernel's query and key tile; it is built for 64 x 64 only, and
    other values raise.  One launch a call.
    """
    _check(q, k, v, 4)
    if (block_q, block_s) != (TILE, TILE):
        raise ValueError(f"block_q={block_q}, block_s={block_s}; the kernel's tile "
                         f"is {TILE} x {TILE}")
    if q.device.type == "cpu":
        return prefill_causal_ref(q, k, v)
    B, Hq, T, D = q.shape
    _, Hk, S, _ = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch("flash_prefill_causal", "flash_prefill_causal", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hk,
             T, S, D, 1.0 / math.sqrt(D)])
    return out
