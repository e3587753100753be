"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``kernels/csrc/<name>.cu`` exposes a plain C interface and is compiled
on its own into ``build/kernels/lib<name>-<digest>.so`` at the repository
root (listed in ``.gitignore``).  The digest covers the source, the flags
and the compiler path, so an edited source never loads a stale library.
Building happens at first use, from the checkout's sources only: nothing
is prebuilt or fetched.  ``build_all`` starts one ``nvcc`` per source at
once, so the build takes as long as the slowest source.

Requires the CUDA toolkit (``nvcc`` on ``PATH`` or under ``$CUDA_HOME``,
default ``/usr/local/cuda``) and a Hopper card to run what it builds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuiltLibrary", "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build_all",
           "find_nvcc", "load_library", "source_names"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """One compiled source: where it is and what ``nvcc`` said."""

    name: str
    path: Path
    log: str          # nvcc's output, including the -Xptxas -v summary
    seconds: float    # compile time (0.0 when an identical build existed)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME; the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def source_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _target(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, BuiltLibrary]:
    """Compile every named source (default: all of ``csrc/``) in parallel.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    nvcc = find_nvcc()
    names = source_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, BuiltLibrary] = {}
    running = {}
    for name in names:
        target = _target(name, nvcc)
        log_path = target.with_suffix(".log")
        if target.exists():
            log = log_path.read_text() if log_path.exists() else ""
            out[name] = BuiltLibrary(name, target, log, 0.0)
            continue
        tmp = target.parent / f"{target.name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, log_path, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, log_path, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        out[name] = BuiltLibrary(name, target, log, seconds)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


_LOADED: dict[str, ctypes.CDLL] = {}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, building it first.

    Loaded once per process; the caller declares ``argtypes``/``restype``.
    """
    if name not in _LOADED:
        built = build_all([name])[name]
        _LOADED[name] = ctypes.CDLL(str(built.path))
    return _LOADED[name]
