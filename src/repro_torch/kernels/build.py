"""Build the port's CUDA sources into shared libraries with a plain C
interface, at first use, and load them with ``ctypes``.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into the
build directory (``src/repro_torch/kernels/_build/`` unless
``REPRO_TORCH_BUILD_DIR`` names another), under a file name keyed by a hash
of its sources, the shared headers in ``common/csrc/`` and the flags
(:func:`source_digest`), so an edited source or header rebuilds and an
unchanged one loads the library already there.  Nothing is compiled when a
module is imported: a kernel's wrapper asks for its library when it first
launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# device code shared by several kernels (tensor-core fragments, cp.async),
# on every build's include path
COMMON_INCLUDE = Path(__file__).resolve().parent / "common" / "csrc"


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and "
            "$PATH): the CUDA kernels are built from source at first use")
    return found


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    log: str                  # nvcc's output (ptxas registers / spills)
    build_s: float            # 0.0 when an earlier build was reused


def source_digest(sources: Sequence[Path],
                  include_dir: Path = COMMON_INCLUDE) -> str:
    """Hex digest of the build's flags, the bytes of ``sources`` and of
    every header (``*.cuh``) in ``include_dir``, names included:
    what a library's file name is keyed by."""
    digest = hashlib.sha256()
    for flag in ARCH_FLAGS + NVCC_FLAGS:
        digest.update(flag.encode())
    headers = sorted(Path(include_dir).glob("*.cuh"))
    for path in [*map(Path, sources), *headers]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()


def load_library(name: str, sources: Sequence[Path]) -> BuiltLibrary:
    """Compile ``sources`` into ``<build_dir>/<name>-<hash>.so`` unless
    that file exists, then load it.  A kernel's wrapper calls this once
    per process and keeps the result."""
    so = build_dir() / f"{name}-{source_digest(sources)[:16]}.so"
    log_path = so.with_suffix(".log")
    build_s = 0.0
    if not so.is_file():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS,
               "-I", str(COMMON_INCLUDE), "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)         # atomic: a concurrent build wins whole
    log = log_path.read_text() if log_path.is_file() else ""
    return BuiltLibrary(ctypes.CDLL(str(so)), so, log, build_s)
