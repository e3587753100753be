"""Sparse substrate of the port: the bucketed-ELL layout."""
from .ell import ELLBucket, ELLGraph, ell_from_graph, spmv_ell_ref

__all__ = ["ELLBucket", "ELLGraph", "ell_from_graph", "spmv_ell_ref"]
