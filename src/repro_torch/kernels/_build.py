"""Build ``csrc/*.cu`` with nvcc on first use and load them with ctypes.

Each source is a shared library with a plain C interface. The library
name carries a hash of its source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited kernel is rebuilt and a built one is reused.
Builds go to ``csrc/_build`` (listed in ``.gitignore``); all sources
compile at once, one nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit on the machine with the card")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source not yet built, all nvcc processes started
    together. Returns {kernel name: compiler output} for what it built
    (ptxas reports registers, shared memory and spills there)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for src in sorted(CSRC.glob("*.cu")):
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[src.stem] = (proc, tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode:
                failed.append(f"{name}:\n{logs[name]}")
            else:
                os.replace(tmp, out)     # atomic: concurrent builds agree
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building on first use."""
    if name not in _libs:
        out = _target(CSRC / f"{name}.cu")
        if not out.exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(out))
    return _libs[name]


def function(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, its ctypes
    signature (``argtypes``, an int return) set once, when it is first
    loaded."""
    key = (name, symbol)
    if key not in _fns:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]
