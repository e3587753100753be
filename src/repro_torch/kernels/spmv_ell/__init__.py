"""The paper's push on Hopper: the ELL bucket kernels and their wrappers."""
from .kernel import LAUNCHES, reset_launch_counts, spmv_ell_bucket, spmv_ell_bucket_batch
from .ops import (
    OVF_CHUNK,
    EllPush,
    ita_step_ell,
    prepare_push,
    spmv_ell,
    spmv_ell_batch,
)
from .ref import spmv_ell_bucket_batch_ref, spmv_ell_bucket_ref, spmv_ell_ref

__all__ = ["LAUNCHES", "OVF_CHUNK", "EllPush", "ita_step_ell", "prepare_push",
           "reset_launch_counts", "spmv_ell", "spmv_ell_batch", "spmv_ell_bucket",
           "spmv_ell_bucket_batch", "spmv_ell_bucket_batch_ref",
           "spmv_ell_bucket_ref", "spmv_ell_ref"]
