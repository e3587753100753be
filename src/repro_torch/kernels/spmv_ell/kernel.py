"""Wrappers for the hand-written ELL bucket kernels (``csrc/spmv_ell.cu``).

They replace the Pallas TPU kernels ``spmv_ell_bucket`` and
``spmv_ell_bucket_batch`` of ``src/repro/kernels/spmv_ell/kernel.py``: for
one degree bucket, ``y[r] = sum_k w_padded[src_idx[r, k]]``, and its form
over a [B, n+1] operand.  The kernels are bound by the bytes they move
(the index tile once, the gathered operand values, the outputs); the
source file states the design.

A wrapper checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty``, and launches on the current stream.  A CPU tensor
takes the plain version in ``ref.py``; a CUDA tensor launches the kernel,
or raises.  ``LAUNCHES`` counts kernel launches, and only those.
Index values must lie in [0, n] (the sentinel); the ELL layouts guarantee
it, and checking it here would cost a device sync on every launch.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from .ref import spmv_ell_bucket_batch_ref, spmv_ell_bucket_ref

__all__ = ["LAUNCHES", "reset_launch_counts", "spmv_ell_bucket",
           "spmv_ell_bucket_batch"]

# kernel name -> launches since the last reset (plain integers)
LAUNCHES: dict[str, int] = {"spmv_ell_bucket": 0, "spmv_ell_bucket_batch": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # w, idx, out, rows, k, device, stream
    "spmv_ell_bucket": [_P, _P, _P, _I, _I, _I, _P],
    # w, ldw, idx, out, B, rows, k, device, stream
    "spmv_ell_bucket_batch": [_P, _L, _P, _P, _I, _I, _I, _I, _P],
}
_FUNCS: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _func(name: str, dtype: torch.dtype):
    key = (name, dtype)
    if key not in _FUNCS:
        lib = load_library("spmv_ell")
        fn = getattr(lib, f"{name}_{_DTYPES[dtype]}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        lib.spmv_ell_error_string.argtypes = [ctypes.c_int]
        lib.spmv_ell_error_string.restype = ctypes.c_char_p
        _FUNCS[key] = (fn, lib.spmv_ell_error_string)
    return _FUNCS[key]


def _check(w: torch.Tensor, src_idx: torch.Tensor, w_ndim: int) -> None:
    if w.dtype not in _DTYPES:
        raise TypeError(f"operand must be float32 or float64, got {w.dtype}")
    if src_idx.dtype != torch.int32:
        raise TypeError(f"src_idx must be int32, got {src_idx.dtype}")
    if w.dim() != w_ndim or src_idx.dim() != 2:
        raise ValueError(f"expected a {w_ndim}-D operand and a 2-D src_idx, "
                         f"got {tuple(w.shape)} and {tuple(src_idx.shape)}")
    if w.shape[-1] < 1:
        raise ValueError("operand needs its sentinel zero slot (length n+1 >= 1)")
    if w.device != src_idx.device:
        raise ValueError(f"operand on {w.device}, src_idx on {src_idx.device}")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {w.device}")
    if not (w.is_contiguous() and src_idx.is_contiguous()):
        raise ValueError("operand and src_idx must be contiguous")
    if src_idx.numel() >= 2**31:
        raise ValueError("src_idx too large for the kernel's 32-bit indexing")


def _launch(name: str, w: torch.Tensor, args: list) -> None:
    fn, err_str = _func(name, w.dtype)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = fn(*args, w.device.index, stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({err_str(code).decode()})")
    LAUNCHES[name] += 1


def spmv_ell_bucket(w_padded: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """[n+1] operand (zero at n), int32 [rows, k] indices -> [rows] row sums."""
    _check(w_padded, src_idx, 1)
    if w_padded.device.type == "cpu":
        return spmv_ell_bucket_ref(w_padded, src_idx)
    rows, k = src_idx.shape
    out = torch.empty(rows, dtype=w_padded.dtype, device=w_padded.device)
    if rows and k:
        _launch("spmv_ell_bucket", w_padded,
                [w_padded.data_ptr(), src_idx.data_ptr(), out.data_ptr(), rows, k])
    else:
        out.zero_()
    return out


def spmv_ell_bucket_batch(w_padded: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """[B, n+1] operand (zero column at n), int32 [rows, k] -> [B, rows].

    The index tile is read once for all B rows; row b of the result is
    bitwise equal to ``spmv_ell_bucket(w_padded[b], src_idx)``.
    """
    _check(w_padded, src_idx, 2)
    if w_padded.device.type == "cpu":
        return spmv_ell_bucket_batch_ref(w_padded, src_idx)
    B, ldw = w_padded.shape
    rows, k = src_idx.shape
    out = torch.empty((B, rows), dtype=w_padded.dtype, device=w_padded.device)
    if B and rows and k:
        _launch("spmv_ell_bucket_batch", w_padded,
                [w_padded.data_ptr(), ldw, src_idx.data_ptr(), out.data_ptr(),
                 B, rows, k])
    else:
        out.zero_()
    return out
