"""The paper's workload as a launchable job on the port.

    PYTHONPATH=src python -m repro_torch.launch.pagerank --dataset web-Google \
        --scale 1.0 --method ita --step-impl ell

Port of ``repro/launch/pagerank.py`` for one device.  The reference goes
through ``PageRankEngine``, which a later slice ports; this launcher calls
``ita``, ``power_method`` and ``ita_batch``/``power_method_batch``
directly, as the reference's ``--partition`` branch does for its solvers.
``--batch B`` solves B one-hot personalized-PageRank queries in one pass.
It prints the same lines: graph stats, iterations and ops, and the top-5.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="web-Google",
                    help="Table-3 preset name (stat-matched synthetic)")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--method", default="ita", choices=["ita", "power"])
    ap.add_argument("--step-impl", default="dense",
                    choices=["auto", "dense", "ell"],
                    help="push backend (core/backends.py registry); auto "
                         "picks ell on the card and dense on the CPU")
    ap.add_argument("--batch", type=int, default=0,
                    help="if > 0, solve this many one-hot PPR queries in "
                         "one batched pass instead of one global ranking")
    ap.add_argument("--xi", type=float, default=1e-10)
    ap.add_argument("--c", type=float, default=0.85)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..core import (
        ita,
        ita_batch,
        one_hot_personalizations,
        power_method,
        power_method_batch,
        resolve_step_impl,
    )
    from ..device import resolve_device
    from ..graph import paper_dataset

    device = resolve_device(args.device)
    g = paper_dataset(args.dataset, scale=args.scale, seed=args.seed,
                      device=device)
    print(f"graph: {g.stats()}")
    step_impl = resolve_step_impl(args.step_impl, platform=device.type)
    print(f"device: {device}  step_impl: {step_impl}")

    if args.batch > 0:
        rng = np.random.default_rng(args.seed)
        seeds = rng.choice(g.n, size=args.batch, replace=False)
        P = one_hot_personalizations(g, seeds)
        if args.method == "ita":
            rb = ita_batch(g, P, c=args.c, xi=args.xi, step_impl=step_impl)
        else:
            rb = power_method_batch(g, P, c=args.c, tol=args.xi,
                                    step_impl=step_impl)
        print(f"batched PPR: {rb.stats()}")
        for b in range(min(args.batch, 4)):
            top = torch.argsort(-rb.pi[b], stable=True)[:3].tolist()
            print(f"  seed {int(seeds[b])}: top-3 "
                  f"{[(i, float(rb.pi[b, i])) for i in top]}")
        return 0

    if args.method == "ita":
        r = ita(g, c=args.c, xi=args.xi, step_impl=step_impl)
    else:
        r = power_method(g, c=args.c, tol=args.xi, step_impl=step_impl)
    print(f"method={r.method} iterations={r.iterations} ops={r.ops:.3e} "
          f"wall={r.wall_time_s}s converged={r.converged}")
    top = torch.argsort(-r.pi, stable=True)[:5].tolist()
    print("top-5 vertices:", [(i, float(r.pi[i])) for i in top])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
