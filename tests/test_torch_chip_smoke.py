"""The parts of ``chip_smoke.py`` that a CPU can check.

The script itself needs a card; here it must refuse to run and print no
result, and its bound arithmetic and per-launch operands are checked on a
small graph.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.backends import get_step_impl
from repro_torch.graph import web_graph

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card contract is not observable")
    proc = subprocess.run([sys.executable, str(SCRIPT)], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


@pytest.fixture(scope="module")
def push():
    g = web_graph(300, 30000, gamma_in=1.6, seed=4, device="cpu")
    return get_step_impl("ell").prepare(g)


@pytest.mark.parametrize("batch", [None, 3])
def test_push_inputs_follow_the_launch_chain(smoke, push, batch):
    pairs = smoke.push_inputs(push, torch.float64, torch.device("cpu"),
                              torch.Generator().manual_seed(0), batch=batch)
    assert len(pairs) == len(push.ell.buckets) + len(push.ovf_levels)
    lengths = [w.shape[-1] for w, _ in pairs]
    nb = len(push.ell.buckets)
    assert lengths[: nb + 1] == [push.n + 1] * (nb + 1)
    for i, level in enumerate(push.ovf_levels[:-1]):
        assert lengths[nb + 1 + i] == level.shape[0] + 1  # the partials of the level before
    for w, idx in pairs:
        assert bool((w[..., -1] == 0).all())  # the sentinel slot
        assert int(idx.max()) <= w.shape[-1] - 1
        if batch is not None:
            assert w.shape[0] == batch


def test_bound_counts_each_input_once(smoke):
    w = torch.zeros(11, dtype=torch.float64)
    idx_a = torch.full((4, 8), 10, dtype=torch.int32)
    idx_a[:, :3] = 1  # 12 real gathers, the rest sentinel
    idx_b = torch.full((2, 32), 10, dtype=torch.int32)
    ms, by, nbytes, ops = smoke.bound([(w, idx_a), (w, idx_b)], torch.float64, batch=1)
    # indices once each, outputs once each, the shared operand once
    assert nbytes == (4 * 8 + 2 * 32) * 4 + (4 + 2) * 8 + 11 * 8
    assert ops == 12 and by == "bytes"
    assert ms == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3)
    _, _, nbytes_b, ops_b = smoke.bound([(w[None].repeat(3, 1), idx_a)], torch.float64,
                                        batch=3)
    assert nbytes_b == 4 * 8 * 4 + 4 * 3 * 8 + 3 * 11 * 8 and ops_b == 36
