"""Build the package's CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` compiles with its own nvcc process, all started
together, into an object file; one more nvcc call links the objects into a
shared library with a plain C interface.  This happens at first use, into
``_build/`` beside this package (listed in ``.gitignore``).  The library's
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads the earlier build.  A build failure
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

__all__ = ["KernelLibrary", "kernel_library", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_NVCC_TIMEOUT_S = 600


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    log: str          # nvcc's output, with -Xptxas -v's per-kernel report


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first that fails.
    Returns their outputs, concatenated."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed with exit code {proc.returncode}"
                              f":\n{' '.join(cmd)}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


@functools.lru_cache(maxsize=1)
def kernel_library() -> KernelLibrary:
    """Build (if needed) and load the kernels of ``csrc/``."""
    digest = _digest()
    lib_path = BUILD_DIR / f"libft8_kernels_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{digest}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in _sources()]
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        try:
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                             str(src)]
                            for src, obj in zip(_sources(), objs)])
            log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
            log_path.write_text(log)
            os.replace(tmp, lib_path)
        finally:
            tmp.unlink(missing_ok=True)
            for obj in objs:
                obj.unlink(missing_ok=True)
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(ctypes.CDLL(str(lib_path)), lib_path, log)
