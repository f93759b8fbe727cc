"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by one ``nvcc`` call for ``sm_90a`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries go into
``gan_sr_wind_field_tpu_torch/_build/`` under a name that carries a hash of
the sources and flags; an existing library is reused only when that hash
matches. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit missing or not on PATH)")


def sources() -> list:
    """Stems of the CUDA sources, one library each."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of the source,
    every header next to it and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libwindsr_{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that have no library with a
    matching hash yet, one ``nvcc`` process per source, all started
    together. Returns ``{name: (path, seconds, ptxas report)}`` (seconds 0
    and the report kept beside the library where it was built before);
    raises on the first failed or timed-out build."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    report = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            report[name] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib, time.monotonic())
    try:
        for name, (proc, tmp, lib, t0) in jobs.items():
            try:
                log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"nvcc for {name}.cu did not finish in {BUILD_TIMEOUT_S} s"
                ) from None
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)  # atomic: concurrent builders never see half
            report[name] = (lib, time.monotonic() - t0, log)
    finally:
        for proc, tmp, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return report


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib_path, _, _ = build([name])[name]
    return ctypes.CDLL(str(lib_path))


def warm(names) -> None:
    """Build the named sources together and load them, so that the first
    call that launches one of their kernels pays for neither."""
    names = list(names)
    if names:
        build(names)
        for name in names:
            load_library(name)
