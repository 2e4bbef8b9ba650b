"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles to a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), at first use,
into ``build/e4t_torch_kernels/`` at the root of the checkout. The file
name carries a hash of the source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source rebuilds and a stale library is never
loaded. A name ``<source>@<n>`` is part n of a source built in parts: the
same file compiled with ``E4T_PART=n`` defined, which keeps only that
part's entry points (and so instantiates only their kernels), so that the
parts compile side by side. ``launch`` calls a library's entry point on
the current CUDA stream and raises on the CUDA error it returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "e4t_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_and_flags(name: str):
    """(the ``.cu`` file, nvcc's flags) of ``name`` (``<source>`` or
    ``<source>@<part>``)."""
    source, _, part = name.partition("@")
    flags = NVCC_FLAGS + ((f"-DE4T_PART={int(part)}",) if part else ())
    return CSRC_DIR / f"{source}.cu", flags


def library_path(name: str) -> Path:
    source, flags = _source_and_flags(name)
    digest = hashlib.sha256()
    for path in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name.replace('@', '-p')}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the compiler output (ptxas register and shared-memory counts,
    also kept in ``<lib>.log``), or the kept log when nothing was built.
    Raises if the compile fails."""
    lib = library_path(name)
    log_path = Path(str(lib) + ".log")
    if lib.exists():
        return log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    source, flags = _source_and_flags(name)
    proc = subprocess.run(
        [nvcc_path(), *flags, "-o", tmp, str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    log_path.write_text(proc.stdout)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def launch(name: str, symbol: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call the entry point ``symbol`` of ``csrc/<name>.cu`` with ``args``
    (of ctypes types ``argtypes``) and, last, the current CUDA stream of
    ``device``. Every entry point returns ``cudaGetLastError()`` after its
    launch; a non-zero value raises, with the CUDA error's text."""
    lib = load_library(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.e4t_cuda_error_string.argtypes = [ctypes.c_int]
        lib.e4t_cuda_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.e4t_cuda_error_string(rc).decode()}")
