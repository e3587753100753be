"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

The same numpy-built inputs go through the JAX reference (``repro``) and
the PyTorch port (``repro_torch``) on the CPU; these helpers move data
between the two as numpy arrays.
"""
import numpy as np
import torch

from repro_torch.graph import graph_from_arrays
from repro_torch.sparse.ell import ELLBucket, ELLGraph


def host(x) -> np.ndarray:
    """numpy view of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_graph(gj, device="cpu"):
    """The port's Graph holding the reference graph's very arrays."""
    return graph_from_arrays(host(gj.src), host(gj.dst), host(gj.out_deg),
                             host(gj.in_deg), gj.n, device=device)


def port_ell(ej, device="cpu") -> ELLGraph:
    """The port's ELLGraph holding the reference layout's very arrays."""
    def put(a):
        return torch.from_numpy(np.array(host(a), dtype=np.int32)).to(device)

    buckets = tuple(ELLBucket(row_ids=put(b.row_ids), src_idx=put(b.src_idx),
                              k=b.k, rows=b.rows) for b in ej.buckets)
    return ELLGraph(buckets=buckets, ovf_src=put(ej.ovf_src),
                    ovf_dst=put(ej.ovf_dst), n=ej.n, m=ej.m,
                    sentinel=ej.sentinel)


def assert_graph_equal(gt, gj) -> None:
    assert (gt.n, gt.m) == (gj.n, gj.m)
    for f in ("src", "dst", "out_deg", "in_deg"):
        a, b = host(getattr(gt, f)), host(getattr(gj, f))
        assert a.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)

