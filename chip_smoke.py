#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out PATH]

Phases; each raises on a failed check, and the script then exits non-zero:

  1. card and build — the ``nvidia-smi`` line, torch and CUDA versions, and
     the ``nvcc`` build of every kernel source with its ``-Xptxas -v``
     summary;
  2. kernels against their plain versions — at web-Google scale 1.0, every
     ELL bucket and every overflow chunk level, in float32 and float64, the
     batch kernel at B=16 with each row bitwise equal to the single kernel;
  3. main path — ``ita[ell]``, ``power[ell]``, ``ita[dense]`` and
     ``ita_batch[ell]`` (B=16) through the port's entry points, with the
     launch counters zeroed just before and read just after;
  4. timings — each kernel, its plain version and one PyTorch library call
     at the main path's shapes (CUDA events, L2 flushed before each
     repetition), each solve end to end, and the top device operations of
     each solve from ``torch.profiler``;
  5. the ``kernels`` JSON line, the card line and the ``ok`` line (last).

Needs one CUDA card, ``nvcc`` and this repository's ``src/``; imports no
JAX.  ``--out`` also writes every number as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # non-tensor-core rates, same sheet
              torch.float64: 34e12}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # rtol and atol, as in the reference tests
BATCH = 16
SOLVE_REPS = 7  # timed warm runs of each solve; the median is reported
DATASET, SCALE, SEED = "web-Google", 1.0, 0


def log(msg: str = "") -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")
    log(f"  [ok] {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def phase_build() -> dict:
    from repro_torch.kernels.build import build_all
    log(f"== card: {card_line()}")
    log(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = build_all()
    log(f"== build: {len(libs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log(f"   {lib.name}: {lib.path.name} ({lib.seconds:.1f} s)")
        for line in lib.log.splitlines():
            if "Used" in line or "Compiling" in line or "spill" in line:
                log(f"     {line.strip()}")
    return {name: lib.seconds for name, lib in libs.items()}


# ---------------------------------------------------------------- phase 2
def push_inputs(push, dtype, dev, gen, batch=None):
    """(operand, index matrix) for every launch of one push: the buckets and
    the first overflow level gather from an [n+1] operand, each later
    level from the partial sums of the one before.  Operands are random,
    with the sentinel slot zero; launches of one operand length share it."""
    lengths = [push.n + 1] * len(push.ell.buckets)
    length = push.n + 1
    for level in push.ovf_levels:
        lengths.append(length)
        length = level.shape[0] + 1
    indices = [b.src_idx for b in push.ell.buckets] + list(push.ovf_levels)
    operands = {}
    for length in lengths:
        if length not in operands:
            shape = (length,) if batch is None else (batch, length)
            w = torch.rand(shape, generator=gen, dtype=dtype).to(dev)
            w[..., -1] = 0
            operands[length] = w
    return [(operands[length], idx) for length, idx in zip(lengths, indices)]


def phase_kernels(push, dev) -> dict:
    from repro_torch.kernels.spmv_ell import (
        spmv_ell_bucket,
        spmv_ell_bucket_batch,
        spmv_ell_bucket_batch_ref,
        spmv_ell_bucket_ref,
    )
    log("== kernels against plain versions (every bucket + overflow level)")
    gen = torch.Generator().manual_seed(SEED)
    errs = {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        e1 = e2 = r1 = r2 = 0.0
        for w, idx in push_inputs(push, dtype, dev, gen):
            y, ref = spmv_ell_bucket(w, idx), spmv_ell_bucket_ref(w, idx)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, ref, rtol=tol, atol=tol)
            e1 = max(e1, float((y - ref).abs().max()))
            r1 = max(r1, float(((y - ref).abs() / (1 + ref.abs())).max()))
        for W, idx in push_inputs(push, dtype, dev, gen, batch=BATCH):
            Y, ref = spmv_ell_bucket_batch(W, idx), spmv_ell_bucket_batch_ref(W, idx)
            torch.cuda.synchronize()
            torch.testing.assert_close(Y, ref, rtol=tol, atol=tol)
            e2 = max(e2, float((Y - ref).abs().max()))
            r2 = max(r2, float(((Y - ref).abs() / (1 + ref.abs())).max()))
            for b in range(BATCH):
                if not torch.equal(Y[b], spmv_ell_bucket(W[b].contiguous(), idx)):
                    raise RuntimeError(f"batch row {b} differs from the single kernel "
                                       f"(k={idx.shape[1]}, {dtype})")
        name = str(dtype).replace("torch.", "")
        log(f"  spmv_ell_bucket       {name}: max |err| {e1:.3e}, max |err|/(1+|ref|) "
            f"{r1:.3e} (tolerance: |err| <= {tol:g} + {tol:g}|ref|)")
        log(f"  spmv_ell_bucket_batch {name}: max |err| {e2:.3e}, max |err|/(1+|ref|) "
            f"{r2:.3e} (tolerance: |err| <= {tol:g} + {tol:g}|ref|); B={BATCH} rows "
            f"bitwise equal to the single kernel")
        errs[dtype] = (e1, e2)
    check(True, "both kernels hold against their plain versions, f32 and f64")
    return errs


def phase_push(g, push, dev) -> None:
    from repro_torch.core.backends import get_step_impl
    from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_batch
    from repro_torch.sparse.ell import spmv_ell_ref
    log("== full push (buckets + chunked overflow) against the plain oracle")
    gen = torch.Generator().manual_seed(SEED + 1)
    W = torch.rand((4, g.n), generator=gen, dtype=torch.float64).to(dev)
    y = spmv_ell(push, W[0])
    y_ref = spmv_ell_ref(push.ell, W[0])
    err = float((y - y_ref).abs().max())
    check(err <= 1e-12 * max(1.0, float(y_ref.abs().max())),
          f"spmv_ell vs plain oracle: max |err| {err:.3e}")
    Y = spmv_ell_batch(push, W)
    check(all(torch.equal(Y[b], spmv_ell(push, W[b])) for b in range(4)),
          "spmv_ell_batch rows bitwise equal to spmv_ell")
    dense = get_step_impl("dense")
    y1, y2 = dense.push(g, None, W[0]), dense.push(g, None, W[0])
    check(torch.equal(y1, y2), "dense push is deterministic (two runs bitwise equal)")
    d_err = float((y1 - y).abs().max())
    check(d_err <= 1e-12 * max(1.0, float(y.abs().max())),
          f"dense push vs ell push: max |err| {d_err:.3e}")


# ---------------------------------------------------------------- phase 3
def top5(pi):
    return torch.argsort(-pi, stable=True)[:5].tolist()


def phase_main_path(g, push, dev) -> dict:
    from repro_torch.core import (
        ita,
        ita_batch,
        one_hot_personalizations,
        power_method,
        reference_pagerank,
        run_ita_loop,
    )
    from repro_torch.kernels.spmv_ell import LAUNCHES, reset_launch_counts
    log("== main path: ita[ell], power[ell], ita[dense], ita_batch[ell] B=16, "
        "launch counts zeroed just before each solve and read just after")
    seeds = np.random.default_rng(SEED).choice(g.n, size=BATCH, replace=False)
    P = one_hot_personalizations(g, seeds)

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        r = fn()
        torch.cuda.synchronize()
        return r, dict(LAUNCHES)

    r_ita, n_ita = counted(lambda: ita(g, step_impl="ell", ctx=push))
    r_pow, n_pow = counted(lambda: power_method(g, step_impl="ell", ctx=push))
    r_dense, n_dense = counted(lambda: ita(g, step_impl="dense"))
    (rb, (PiBar, H)), n_batch = counted(lambda: ita_batch(
        g, P, step_impl="ell", ctx=push, return_state=True))
    # one push launches the kernel once per non-empty bucket and once per
    # overflow level
    per_push = sum(b.src_idx.numel() > 0 for b in push.ell.buckets) + len(push.ovf_levels)
    per_path = {}
    for label, r, n, kernel in (("ita[ell]", r_ita, n_ita, "spmv_ell_bucket"),
                                ("power[ell]", r_pow, n_pow, "spmv_ell_bucket"),
                                ("ita[dense]", r_dense, n_dense, None),
                                ("ita_batch[ell]", rb, n_batch, "spmv_ell_bucket_batch")):
        want = {k: (per_push * r.iterations if k == kernel else 0) for k in LAUNCHES}
        per_path[label] = n
        log(f"  {label}: iterations={r.iterations} "
            + (f"ops={r.ops:.9g} " if hasattr(r, "ops") else "")
            + f"converged={r.converged} wall={r.wall_time_s:.4f} s launches={n}")
        check(n == want, f"{label}: launches {n} == " + (
            f"{per_push} per push x {r.iterations} rounds on {kernel}, 0 elsewhere"
            if kernel else "none (the dense push runs no kernel of this path)"))
    launches = {k: sum(n[k] for n in per_path.values()) for k in LAUNCHES}
    log(f"  launches on the main path, all four solves: {launches}")
    check(all(v > 0 for v in launches.values()),
          "every kernel of the path launched on the main path")
    check(r_ita.converged and r_pow.converged and r_dense.converged and rb.converged,
          "every solve converged")
    for name, pi in (("ita[ell]", r_ita.pi), ("power[ell]", r_pow.pi),
                     ("ita[dense]", r_dense.pi)):
        check(pi.device == torch.device("cuda", 0) and bool(torch.isfinite(pi).all())
              and abs(float(pi.sum()) - 1.0) <= 1e-12 and pi.shape == (g.n,),
              f"{name}: pi on cuda:0, finite, [n], sums to 1")
    check(rb.pi.shape == (BATCH, g.n) and bool(torch.isfinite(rb.pi).all())
          and float((rb.pi.sum(1) - 1).abs().max()) <= 1e-12,
          "ita_batch: pi [16, n] on the card, finite, rows sum to 1")
    d_ip = float((r_ita.pi - r_pow.pi).abs().max())
    check(d_ip <= 1e-9, f"ita[ell] vs power[ell]: max |diff| {d_ip:.3e} <= 1e-9")
    d_ed = float((r_ita.pi - r_dense.pi).abs().max())
    check(d_ed <= 1e-12 and r_ita.iterations == r_dense.iterations
          and r_ita.ops == r_dense.ops,
          f"ita[ell] vs ita[dense]: max |diff| {d_ed:.3e}, same iterations and ops")
    pi_ref = reference_pagerank(g)
    d_ref = float((r_ita.pi - pi_ref).abs().max())
    check(d_ref <= 1e-9, f"ita[ell] vs reference_pagerank: max |diff| {d_ref:.3e}")
    tops = {name: top5(pi) for name, pi in (("ita[ell]", r_ita.pi),
                                            ("power[ell]", r_pow.pi),
                                            ("ita[dense]", r_dense.pi),
                                            ("reference", pi_ref))}
    log(f"  top-5: {tops['ita[ell]']}")
    check(len({tuple(t) for t in tops.values()}) == 1,
          "top-5 equal across ita/power, dense/ell and the reference")
    check(all(int(torch.argmax(rb.pi[b])) == int(s) for b, s in enumerate(seeds)),
          "each batch row ranks its own seed first")
    same = True
    for b in range(BATCH):
        h0 = P[b] * g.n
        h, pi_bar, n_active, _, _ = run_ita_loop(
            g, h0, torch.zeros_like(h0), c=0.85, xi=1e-10, max_iter=10_000,
            impl="ell", ctx=push)
        same &= n_active == 0 and torch.equal(PiBar[b] + H[b], pi_bar + h)
    check(same, "batch rows bitwise equal to 16 sequential ita[ell] solves (PiBar + H)")
    return dict(launches=launches, launches_per_path=per_path,
                solves={r.method: dict(iterations=r.iterations, ops=r.ops,
                                       wall_s=r.wall_time_s)
                        for r in (r_ita, r_pow, r_dense)}
                | {rb.method: dict(iterations=rb.iterations, wall_s=rb.wall_time_s)},
                max_diff=dict(ita_vs_power=d_ip, ell_vs_dense=d_ed, ita_vs_ref=d_ref),
                top5=tops["ita[ell]"], seeds=[int(s) for s in seeds])


# ---------------------------------------------------------------- phase 4
class Timer:
    """CUDA-event timing of the device work ``fn`` queues, the L2 flushed
    before every repetition.

    After the flush the device spins for about 2 ms, so the host has queued
    all of ``fn``'s launches before the start event fires: the time is the
    device's, not the host's launch rate.
    """

    SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's 1.98 GHz boost clock

    def __init__(self, dev, reps: int = 20, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        events = []
        for _ in range(self.reps):
            self.flush_buf.zero_()  # 128 MB through the 50 MB L2
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.mean([s.elapsed_time(e) for s, e in events]))


def bound(pairs, dtype, batch: int) -> tuple[float, str, int, int]:
    """Least time for the launches of one push: bytes (each input once,
    each output once) over the HBM rate, against the real (non-sentinel)
    adds over the dtype's peak rate; the larger of the two."""
    item = torch.finfo(dtype).bits // 8
    nbytes, ops, seen = 0, 0, set()
    for w, idx in pairs:
        rows, k = idx.shape
        nbytes += rows * k * 4 + rows * batch * item
        if w.data_ptr() not in seen:
            seen.add(w.data_ptr())
            nbytes += w.numel() * item
        ops += int((idx != w.shape[-1] - 1).sum()) * batch
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, ops


def phase_timings(push, dev, errs, main) -> dict:
    from repro_torch.kernels.spmv_ell import (
        spmv_ell_bucket,
        spmv_ell_bucket_batch,
        spmv_ell_bucket_batch_ref,
        spmv_ell_bucket_ref,
    )
    F = torch.nn.functional
    log("== timings (CUDA events, L2 flushed before each repetition, f64; "
        "one push = all its launches queued back to back)")
    timer = Timer(dev)
    gen = torch.Generator().manual_seed(SEED + 2)
    dtype = torch.float64
    rows = []
    for name, batch in (("spmv_ell_bucket", 1), ("spmv_ell_bucket_batch", BATCH)):
        pairs = push_inputs(push, dtype, dev, gen, batch=None if batch == 1 else batch)
        if batch == 1:
            kern = [(lambda w=w, i=i: spmv_ell_bucket(w, i)) for w, i in pairs]
            plain = [(lambda w=w, i=i: spmv_ell_bucket_ref(w, i)) for w, i in pairs]
            lib = [(lambda w=w[:, None], i=i.long(): F.embedding_bag(i, w, mode="sum"))
                   for w, i in pairs]
        else:
            kern = [(lambda w=w, i=i: spmv_ell_bucket_batch(w, i)) for w, i in pairs]
            plain = [(lambda w=w, i=i: spmv_ell_bucket_batch_ref(w, i)) for w, i in pairs]
            lib = [(lambda w=w.t().contiguous(), i=i.long():
                    F.embedding_bag(i, w, mode="sum")) for w, i in pairs]

        def run(fns):
            return lambda: [f() for f in fns]

        t_k, t_p, t_l = timer(run(kern)), timer(run(plain)), timer(run(lib))
        b_ms, b_by, nbytes, ops = bound(pairs, dtype, batch)
        per = [timer(f) for f in kern]
        shapes = [tuple(i.shape) for _, i in pairs]
        log(f"  {name} (one push, {len(pairs)} launches, B={batch}): kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, embedding_bag {t_l:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {ops:.3g} adds), "
            f"{nbytes / (t_k * 1e-3) / 1e9:.0f} GB/s")
        log(f"     each launch alone (operand cold every time): sum {sum(per):.4f} ms")
        for s, t in zip(shapes, per):
            log(f"     launch {s}: {t:.4f} ms")
        e = errs[torch.float64][0 if batch == 1 else 1]
        e32 = errs[torch.float32][0 if batch == 1 else 1]
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/spmv_ell.cu",
            replaces="src/repro/kernels/spmv_ell/kernel.py:"
                     + ("48" if batch == 1 else "89"),
            launches=main["launches"][name], max_abs_err=e, ms=t_k, plain_ms=t_p,
            bound_ms=b_ms, bound_by=b_by, library_ms=t_l,
            shape=f"one push at {DATASET} scale {SCALE}: {len(pairs)} launches "
                  f"{shapes}, B={batch}, f64",
            max_abs_err_f32=e32, per_launch_ms=per))
    return dict(kernels=rows)


def _self_device_us(e) -> float:
    # the attribute's name changed across torch versions
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)))


def phase_solves(g, push) -> dict:
    from repro_torch.core import ita, ita_batch, one_hot_personalizations, power_method
    log("== solves end to end (warm, host clock with synchronize) and profiles; "
        "the profiled run is one more")
    seeds = np.random.default_rng(SEED).choice(g.n, size=BATCH, replace=False)
    P = one_hot_personalizations(g, seeds)
    solves = {
        "ita[ell]": lambda: ita(g, step_impl="ell", ctx=push),
        "power[ell]": lambda: power_method(g, step_impl="ell", ctx=push),
        "ita[dense]": lambda: ita(g, step_impl="dense"),
        f"ita_batch[ell] B={BATCH}": lambda: ita_batch(g, P, step_impl="ell", ctx=push),
    }
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, fn in solves.items():
        fn()
        walls = []
        for _ in range(SOLVE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(_self_device_us(e) for e in kernels)
        log(f"  {name}: warm wall median {wall * 1e3:.3f} ms of {SOLVE_REPS} runs "
            f"(min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}); device "
            f"{dev_us / 1e3:.3f} ms in {len(kernels)} kernels (busy share "
            f"{dev_us / 1e3 / (wall * 1e3):.3f})")
        tops = []
        for e in sorted(kernels, key=lambda e: -_self_device_us(e))[:6]:
            t = _self_device_us(e) / 1e3
            log(f"     {t:10.3f} ms  x{e.count:<6d} {e.key[:70]}")
            tops.append(dict(name=e.key, ms=t, count=e.count))
        out[name] = dict(wall_ms=wall * 1e3, wall_ms_runs=[w * 1e3 for w in walls],
                         device_ms=dev_us / 1e3, top=tops)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write every number as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.backends import get_step_impl
    from repro_torch.graph import paper_dataset

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    build_s = phase_build()
    t0 = time.perf_counter()
    g = paper_dataset(DATASET, scale=SCALE, seed=SEED, device=dev)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    push = get_step_impl("ell").prepare(g)
    t_prep = time.perf_counter() - t0
    ell = push.ell
    log(f"== graph {DATASET} scale {SCALE}: {g.stats()} built in {t_graph:.1f} s; "
        f"ELL + overflow chunks in {t_prep:.1f} s")
    log(f"   buckets (k, rows): {[(b.k, b.rows) for b in ell.buckets]}, overflow "
        f"{ell.fill_stats()['overflow_edges']} edges on {push.ovf_rows.numel()} rows, "
        f"chunk levels {[tuple(lv.shape) for lv in push.ovf_levels]}")
    errs = phase_kernels(push, dev)
    phase_push(g, push, dev)
    main_out = phase_main_path(g, push, dev)
    timings = phase_timings(push, dev, errs, main_out)
    solves = phase_solves(g, push)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    kernels_line = json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "shape", "max_abs_err_f32")}
        for row in timings["kernels"]]})
    card = card_line()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=card, torch=torch.__version__, cuda=torch.version.cuda,
            build_s=build_s, graph=g.stats(), main_path=main_out,
            kernels=timings["kernels"], solves=solves), indent=1))
    print(kernels_line)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
