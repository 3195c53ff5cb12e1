"""Build helper for the port's CUDA kernels: nvcc into a shared library with
a plain C interface, loaded with ctypes.

The library is built from the package's own sources on first use into
``build/kernels/`` at the repository root (listed in .gitignore); its file
name carries a hash of the sources, the headers of csrc/ and the flags, so
an edited source or header builds anew and an unchanged one is reused. A
build writes to a temporary name and renames it into place, so concurrent
builds never load a half-written library; ptxas's report (registers, stack
frame, spills) is kept beside the library. Nothing here runs at import
time.
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def library_path(name: str, sources: tuple[str, ...], defines: tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256()
    for src in [*sources, *sorted(p.name for p in CSRC.glob("*.cuh"))]:
        digest.update(src.encode())
        digest.update((CSRC / src).read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_library(name: str, sources: tuple[str, ...], defines: tuple[str, ...] = (), verbose: bool = True) -> tuple[Path, float]:
    """Build (or reuse) lib<name>_<hash>.so from csrc/<sources>, with the
    preprocessor ``defines`` (``-DNAME=VALUE`` flags). Returns (path, build
    seconds; 0.0 when the library was already built). Different libraries
    can build at once from several threads: nvcc runs as a subprocess."""
    out = library_path(name, sources, defines)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *defines, "-Xptxas", "-v", "-o", str(tmp), *[str(CSRC / s) for s in sources]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    ptxas = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln or "stack frame" in ln]
    out.with_suffix(".ptxas").write_text("\n".join(ptxas) + "\n")
    if verbose:
        print(f"[build] nvcc {name}: {seconds:.1f} s -> {out}", flush=True)
        for ln in ptxas:
            print(f"[build]   {ln}", flush=True)
    return out, seconds


def ptxas_report(path: Path) -> list[str]:
    """What ptxas said of the library at ``path`` when it was built (-Xptxas
    -v): per kernel its registers, stack frame and spill bytes."""
    report = Path(path).with_suffix(".ptxas")
    return report.read_text().splitlines() if report.exists() else []


def load_library(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))
