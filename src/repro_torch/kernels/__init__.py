"""Hand-written Hopper kernels of the port, each beside its plain version.

  spmv_ell         — the paper's push: bucketed-ELL gather-sum (CUDA C++, sm_90a)
  flash_attention  — decode (split-KV) + causal prefill (CUDA C++, sm_90a)

``build.py`` compiles ``csrc/*.cu`` with nvcc at first use.  Importing this
package builds nothing and needs no CUDA toolkit.
"""
from .flash_attention import attention_decode, attention_prefill_causal
from .spmv_ell import ita_step_ell, spmv_ell

__all__ = ["attention_decode", "attention_prefill_causal", "ita_step_ell",
           "spmv_ell"]
