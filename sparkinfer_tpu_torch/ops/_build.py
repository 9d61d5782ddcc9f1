"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain `extern "C"` interface and becomes
`build/kernels/<name>-<hash>.so` at the repository root, where the hash covers
the source, the shared headers `csrc/*.cuh` and the compiler flags, so an
edited source never loads a stale library. Nothing here runs at import: the
first wrapper call on a CUDA tensor builds (if needed) and loads the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # sources include them by name
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: list[str]) -> dict[str, tuple[Path, float, str]]:
    """Compile every named source that has no current library, all nvcc
    processes at once. Returns {name: (library, seconds, compiler log)};
    a library that was already built reports 0 seconds and an empty log.
    Raises RuntimeError with the compiler output if any build fails."""
    nvcc = None
    running = {}
    result = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            result[name] = (lib, 0.0, "")
            continue
        if nvcc is None:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, lib, tmp, time.perf_counter())
    failed = []
    for name, (proc, lib, tmp, t0) in running.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
        result[name] = (lib, secs, log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, _, _ = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
