"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-shared -Xcompiler -fPIC``; never ``--use_fast_math``: HYPERBOLIC's scores
need IEEE division, paged attention IEEE exp and tanh).  Libraries go to
``kernels/.build/`` (gitignored), named by a digest of every source and
the flags, so an edited kernel is rebuilt.  On first use the sources of a
group (``GROUPS``) compile at once, one ``nvcc`` each, and ``ptxas -v``
reports (registers, shared memory, spills) are kept for ``build_log``:
the optimizer's pass builds alone, in seconds, so training can run while
the cache and serving kernels build.  A failed build or load raises
``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
#: the sources ``library`` builds together: the optimizer's, then the rest
GROUPS = (("adamw",),
          ("kway_probe", "replay", "replay_hier", "paged_attention"))
SOURCES = tuple(n for group in GROUPS for n in group)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks = {group: threading.Lock() for group in GROUPS}
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler, or RuntimeError."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built on a machine with the CUDA "
        "toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _paths(name: str, digest: str) -> tuple[Path, Path]:
    stem = BUILD_DIR / f"{name}-{digest}"
    return stem.with_suffix(".so"), stem.with_suffix(".log")


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile each of ``names`` whose library is missing, all in
    parallel.  -> {name: path of its .so}."""
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _paths(n, digest) for n in names
            if not _paths(n, digest)[0].exists()}
    procs = {}
    for name, (so, _) in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        so, log = todo[name]
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        log.write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: _paths(n, digest)[0] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use with
    the rest of its group (and under that group's lock only)."""
    group = next(g for g in GROUPS if name in g)
    with _locks[group]:
        if name not in _libs:
            for n, path in build_all(group).items():
                try:
                    _libs[n] = ctypes.CDLL(str(path))
                except OSError as e:
                    raise RuntimeError(
                        f"cannot load CUDA kernel library {path}: {e}") from e
        return _libs[name]


def build_log(name: str) -> str:
    """nvcc/ptxas output of the current build of ``csrc/<name>.cu``."""
    _, log = _paths(name, _digest())
    return log.read_text() if log.exists() else ""


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
