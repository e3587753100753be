"""The paper's solvers on PyTorch: ITA, the power method and batched PPR."""
from .api import reference_pagerank
from .backends import (
    STEP_IMPLS,
    BackendCapabilities,
    SolverBackend,
    available_step_impls,
    choose_backend,
    get_step_impl,
    register_step_impl,
    resolve_step_impl,
    run_ita_loop,
)
from .batch import (
    BatchSolverResult,
    ita_batch,
    one_hot_personalizations,
    power_method_batch,
)
from .ita import ita, ita_fixed_point, ita_step, ita_traced
from .metrics import SolverResult, err_max_rel, l1_diff, res_l2
from .power import power_method, power_method_traced, power_step
from .propagate import dangling_mass, push_weighted, spmv_p

__all__ = [
    "BackendCapabilities", "BatchSolverResult", "STEP_IMPLS", "SolverBackend",
    "SolverResult", "available_step_impls", "choose_backend",
    "dangling_mass", "err_max_rel", "get_step_impl", "ita", "ita_batch",
    "ita_fixed_point", "ita_step", "ita_traced", "l1_diff",
    "one_hot_personalizations", "power_method", "power_method_batch",
    "power_method_traced", "power_step", "push_weighted", "reference_pagerank",
    "register_step_impl", "res_l2", "resolve_step_impl", "run_ita_loop",
    "spmv_p",
]
