"""Build the port's CUDA sources into shared libraries with a plain C interface.

Each ``pygcn_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into ``pygcn_tpu_torch/_build/lib<name>.so`` (a directory git ignores) at
first use, and rebuilt when the source, or a header beside it, is newer than
the library. The libraries include no PyTorch headers, so a build takes
seconds; wrappers load them with ctypes. Several sources build in parallel,
one ``nvcc`` each.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("bcsr_spmm", "colpanel_spmm", "ell_spmm", "gat_tile_attn", "gatv2_tile_attn")


def nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is not installed."""
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return max(p.stat().st_mtime for p in sources) > lib.stat().st_mtime


def build(names=SOURCES, *, force: bool = False) -> dict:
    """Compile the named sources (all at once) and return ``{name: nvcc log}``.

    Sources whose library is up to date are skipped (empty log) unless
    ``force``. Each compile writes a temporary file that is renamed into
    place, so a concurrent build never leaves a truncated library. Raises
    ``RuntimeError`` with the compiler's output when any compile fails.
    """
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {n: "" for n in names}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp.{os.getpid()}"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {n: "" for n in names}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs
