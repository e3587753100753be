"""Hand-written Hopper kernels of the port, each beside its plain version.

  spmv_ell — the paper's push: bucketed-ELL gather-sum (CUDA C++, sm_90a)

``build.py`` compiles ``csrc/*.cu`` with nvcc at first use.  Importing this
package builds nothing and needs no CUDA toolkit.
"""
