"""ctypes bindings for the C++ fused image-preprocess kernel.

Counterpart of ``e4t_diffusion_tpu/data/native_ops.py`` over the port's own
copy of the source, ``csrc/e4t_image.cc``, with the same C interface
(``fused_preprocess``, ``resized_dims``) and the same
``make_native_transform``. The library is built with g++ (``$CXX`` when
set) at first use, with the flags of ``native/Makefile``, into
``build/e4t_torch_native/`` at the root of the checkout. Which flags is
decided once per compiler by a probe (``build_flags``): a toolchain that
cannot link OpenMP's runtime (no ``libgomp``) builds without
``-fopenmp``; the pragma only deals the output rows out to threads, so
the bits are the same, single-threaded. The library's file name carries a
hash of the source, the compiler and the flags it is built with, so an
edited source or another flag set rebuilds and a stale library is never
loaded; with ``-march=native`` it also carries the host's CPU model and
flags, so a checkout shared by hosts of other CPUs builds one library for
each. The command that built it is kept in ``<library>.log``. Importing
this module builds nothing. A build or load that fails raises with the
compiler's or the loader's message: there is no quiet fallback to cv2 here
(the JAX module falls back). ``E4T_DISABLE_NATIVE=1`` is the one way to
take the numpy/cv2 transform (``native_enabled``), which the data loader
reads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "e4t_image.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "e4t_torch_native"
# native/Makefile's CXXFLAGS and link step
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-shared")
DISABLE_KNOB = "E4T_DISABLE_NATIVE"

_lib: Optional[ctypes.CDLL] = None
# compiler -> (the flags it builds with, the OpenMP probe's output if it
# failed)
_probed: Dict[str, Tuple[Tuple[str, ...], str]] = {}
_lock = threading.Lock()


def native_enabled() -> bool:
    """False only while ``E4T_DISABLE_NATIVE=1`` (read per call)."""
    return os.environ.get(DISABLE_KNOB, "0") != "1"


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _cpu_id() -> str:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), from /proc/cpuinfo where there is one."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            lines = f.read().split("\n\n")[0].splitlines()
    except OSError:
        return platform.machine() + platform.processor()
    return "\n".join(ln for ln in lines
                     if ln.split(":")[0].strip() in ("model name", "flags"))


def _probe() -> Tuple[Tuple[str, ...], str]:
    cxx = _compiler()
    if cxx not in _probed:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                proc = subprocess.run(
                    [cxx, *CXX_FLAGS, "-x", "c++", "-o",
                     os.path.join(tmp, "probe.so"), "-"],
                    input="int e4t_probe() { return 0; }\n",
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                failed = proc.stdout if proc.returncode else ""
            except OSError as e:
                failed = str(e)
        flags = (tuple(f for f in CXX_FLAGS if f != "-fopenmp") if failed
                 else CXX_FLAGS)
        _probed[cxx] = (flags, failed)
    return _probed[cxx]


def build_flags() -> Tuple[str, ...]:
    """``CXX_FLAGS`` if the compiler links an empty unit with them, else the
    same without ``-fopenmp``; probed once per compiler and process."""
    return _probe()[0]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((_compiler(),) + build_flags()).encode())
    digest.update(_cpu_id().encode())
    return BUILD_DIR / f"libe4t_image-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/e4t_image.cc`` unless an up-to-date library exists;
    returns its path. Raises with the compiler's output if it fails."""
    lib = library_path()
    if lib.exists():
        return lib
    flags, probe_failed = _probe()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_compiler(), *flags, "-o", tmp, str(SOURCE)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name}: {e}") from e
    except BaseException:
        os.unlink(tmp)
        raise
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{_compiler()} failed for {SOURCE.name} "
                           f"(set {DISABLE_KNOB}=1 for the cv2 transform):"
                           f"\n{proc.stdout}")
    log = " ".join([_compiler(), *flags, SOURCE.name]) + "\n"
    if probe_failed:
        log += f"without -fopenmp, which did not link:\n{probe_failed}"
    Path(str(lib) + ".log").write_text(log + proc.stdout)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    return lib


def build_log() -> str:
    """How the library was built: the compiler command (its first line),
    and the OpenMP probe's failure when it was built without
    ``-fopenmp``."""
    path = Path(str(build()) + ".log")
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The library, built first if needed (raises if that fails)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.fused_preprocess.restype = ctypes.c_int
            lib.fused_preprocess.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.resized_dims.restype = None
            lib.resized_dims.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            _lib = lib
    return _lib


def resized_dims(h: int, w: int, target: int) -> Tuple[int, int]:
    """(rows, columns) of an h x w image with its short side resized to
    ``target``."""
    rh, rw = ctypes.c_int(), ctypes.c_int()
    load().resized_dims(h, w, target, ctypes.byref(rh), ctypes.byref(rw))
    return rh.value, rw.value


def fused_preprocess(image: np.ndarray, target: int, crop_top: int,
                     crop_left: int, flip: bool) -> np.ndarray:
    """uint8 HWC RGB -> float32 CHW in [-1, 1]; resize short side to
    ``target`` (area), crop at (crop_top, crop_left), optional hflip. A crop
    outside the resized image raises ValueError."""
    lib = load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"fused_preprocess takes an HxWx3 RGB image, not "
                         f"{image.shape}")
    h, w = image.shape[:2]
    out = np.empty((3, target, target), np.float32)
    rc = lib.fused_preprocess(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        target, crop_top, crop_left, int(flip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(
            f"fused_preprocess failed (h={h}, w={w}, target={target}, "
            f"crop=({crop_top},{crop_left}))")
    return out


def make_native_transform(size: int, random_crop_flag: bool = False,
                          hflip: bool = True, seed: int = 0):
    """Drop-in replacement for data.dataset.make_transform backed by the
    C++ kernel: the same draws from ``default_rng(seed)`` in the same
    order (crop top, crop left, then the flip)."""
    rng = np.random.default_rng(seed)

    def apply(image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        rh, rw = resized_dims(h, w, size)
        if random_crop_flag:
            top = int(rng.integers(0, rh - size + 1))
            left = int(rng.integers(0, rw - size + 1))
        else:
            top = (rh - size) // 2
            left = (rw - size) // 2
        flip = bool(hflip and rng.random() < 0.5)
        return fused_preprocess(image, size, top, left, flip)

    return apply
