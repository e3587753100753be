"""The port's launcher end to end on the CPU, against the reference solve.

``repro_torch.launch.pagerank.main(["--device", "cpu", ...])`` builds the
graph, solves and prints the reference launcher's lines; its top-5 must
be the reference's top-5 on the same graph.
"""
import ast
import re

import numpy as np
import pytest
import torch

from repro.core.batch import ita_batch as j_ita_batch
from repro.core.batch import one_hot_personalizations as j_one_hot
from repro.core.ita import ita as j_ita
from repro.core.power import power_method as j_power_method
from repro.graph.generators import paper_dataset as j_paper_dataset
from repro_torch.launch.pagerank import main

SCALE = "0.002"


def _run(capsys, *args):
    assert main(["--device", "cpu", "--scale", SCALE, *args]) == 0
    return capsys.readouterr().out


def _top5(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("top-5 vertices:"))
    return ast.literal_eval(line.split(":", 1)[1].strip())


@pytest.fixture(scope="module")
def ref_graph():
    return j_paper_dataset("web-Google", scale=float(SCALE), seed=0)


@pytest.mark.parametrize("method,impl", [("ita", "ell"), ("ita", "dense"),
                                         ("power", "ell"), ("ita", "auto")])
def test_launcher_prints_reference_top5(capsys, ref_graph, method, impl):
    out = _run(capsys, "--method", method, "--step-impl", impl)
    assert f"graph: {ref_graph.stats()}" in out
    resolved = "dense" if impl == "auto" else impl  # auto picks dense on the CPU
    assert f"step_impl: {resolved}" in out
    solve = j_ita if method == "ita" else j_power_method
    r = solve(ref_graph, step_impl=resolved)
    m = re.search(r"iterations=(\d+) ops=(\S+)", out)
    assert int(m.group(1)) == r.iterations
    assert float(m.group(2)) == float(f"{r.ops:.3e}")
    top = _top5(out)
    ref_top = np.argsort(-np.asarray(r.pi), kind="stable")[:5].tolist()
    assert [v for v, _ in top] == ref_top
    np.testing.assert_allclose([p for _, p in top], np.asarray(r.pi)[ref_top],
                               rtol=0, atol=1e-12)


def test_launcher_batch_ranks_each_seed_first(capsys, ref_graph):
    out = _run(capsys, "--method", "ita", "--step-impl", "ell", "--batch", "3")
    assert "batched PPR: {'method': 'ita_batch[ell]', 'batch': 3" in out
    seeds = np.random.default_rng(0).choice(ref_graph.n, size=3, replace=False)
    rb = j_ita_batch(ref_graph, j_one_hot(ref_graph, seeds), step_impl="ell")
    for b, s in enumerate(seeds):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"  seed {s}:"))
        top = ast.literal_eval(line.split("top-3", 1)[1].strip())
        ref_top = np.argsort(-np.asarray(rb.pi[b]), kind="stable")[:3].tolist()
        assert [v for v, _ in top] == ref_top
        np.testing.assert_allclose([p for _, p in top],
                                   np.asarray(rb.pi[b])[ref_top], rtol=0, atol=1e-12)
        assert top[0][0] == int(s)  # each seed ranks itself first


def test_launcher_power_batch(capsys):
    out = _run(capsys, "--method", "power", "--step-impl", "dense", "--batch", "2")
    assert "'method': 'power_batch[dense]'" in out and "'converged': True" in out


def test_launcher_default_device_is_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card contract is not observable")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--scale", SCALE])
