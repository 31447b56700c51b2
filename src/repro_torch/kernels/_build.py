"""Build-on-first-use loader for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface, so it compiles with
``nvcc`` alone (no PyTorch headers: seconds, not minutes) into its own
shared library, loaded with :mod:`ctypes` (a ``csrc/*.cuh`` header holds
code that two sources share). All sources build together —
one ``nvcc`` process per source, started at once — the first time any
kernel is launched, into ``build/repro_torch_kernels/`` at the repository
root (``$REPRO_TORCH_BUILD_DIR`` overrides it). Libraries are keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads straight away.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", *ARCH_FLAGS]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}   # name → {"seconds": s, "ptxas": text}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from csrc/ on first use")


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(src: Path) -> Path:
    """The library path of ``src``, keyed by its bytes, the shared headers'
    (``csrc/*.cuh``) and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every stale source, all ``nvcc`` processes in parallel;
    returns name → library path. Raises with the compiler output on a
    failed build."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(src) for name, src in sources().items()}
    procs = {}
    t0 = time.perf_counter()
    for name, src in sources().items():
        if targets[name].exists():
            continue
        tmp = targets[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu`` (building all kernels on
    the first call)."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        for n, p in paths.items():
            if n not in _LIBS:
                _LIBS[n] = ctypes.CDLL(str(p))
        lib = _LIBS[name]
    return lib
