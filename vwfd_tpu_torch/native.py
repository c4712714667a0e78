"""K25 `blockdct`: the DCT-domain data's host kernel (port of
vwfd_tpu/native.py with csrc/blockdct.cpp).

``blockwise_dct`` computes the orthonormal 8×8 DCT-II of every block of a
float32 plane, (H, W) → (H/8, W/8, 64), or of a batch, (N, H, W) → (N, H/8,
W/8, 64), through ``vwfd_tpu_torch/csrc/blockdct_host.cpp``: C++ built with
the system ``g++`` at first use into ``build/vwfd_tpu_torch/`` at the root of
the checkout (the library's name carries a hash of the source and the
flags) and loaded with ``ctypes``. Nothing is built at import.

Unlike the JAX package's binding there is no numpy fallback: a failed build
raises, naming the compiler's output, so that the data pipeline never
silently computes with another code path. ``blockwise_dct_plain`` is the
plain version (numpy, ``vwfd_tpu/data/jpeg_data.py:49-51``), which the
tests and ``chip_smoke.py`` hold the kernel against. ``COUNT`` counts the
kernel's calls.

``draw_thick_line`` of the JAX package's library has no caller there and is
not ported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .kernels._lib import LaunchCount
from .ops.dct import _dct_matrix_np

__all__ = ["blockwise_dct", "blockwise_dct_plain", "build", "library_path",
           "COUNT", "SOURCE", "CXX_FLAGS"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "blockdct_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "vwfd_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]

COUNT = LaunchCount("blockdct")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvwfd_blockdct_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host kernel with ``g++`` (no-op when the library for this
    source exists); raises if the compiler is missing or fails."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("K25 blockdct needs a C++ compiler (g++) to "
                           "build vwfd_tpu_torch/csrc/blockdct_host.cpp")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a half file
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fp = ctypes.POINTER(ctypes.c_float)
            lib.vwfd_blockdct.argtypes = [fp, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, fp]
            lib.vwfd_blockdct.restype = ctypes.c_int
            _lib = lib
    return _lib


def _shape(plane: np.ndarray):
    if plane.ndim not in (2, 3) or plane.shape[-1] % 8 or \
            plane.shape[-2] % 8:
        raise ValueError(f"blockwise_dct takes (H, W) or (N, H, W) with H "
                         f"and W multiples of 8, got {plane.shape}")
    h, w = plane.shape[-2:]
    return plane.shape[:-2], h, w


def blockwise_dct_plain(plane: np.ndarray) -> np.ndarray:
    """Plain version: ``einsum("ua,...ijab,vb->...ijuv", C, blocks, C)`` in
    float32 (the JAX package's fallback)."""
    lead, h, w = _shape(plane)
    c = _dct_matrix_np(8)
    b = np.asarray(plane, np.float32).reshape(
        *lead, h // 8, 8, w // 8, 8).swapaxes(-3, -2)
    coeff = np.einsum("ua,...ijab,vb->...ijuv", c, b, c)
    return coeff.reshape(*lead, h // 8, w // 8, 64)


def blockwise_dct(plane: np.ndarray) -> np.ndarray:
    """(H, W) or (N, H, W) float32 → (H/8, W/8, 64) or (N, H/8, W/8, 64)
    through the host kernel."""
    lead, h, w = _shape(plane)
    lib = _load()
    src = np.ascontiguousarray(plane, dtype=np.float32)
    n = int(np.prod(lead)) if lead else 1
    out = np.empty((*lead, h // 8, w // 8, 64), dtype=np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.vwfd_blockdct(src.ctypes.data_as(fp), n, h, w,
                           out.ctypes.data_as(fp))
    if rc != 0:
        raise ValueError(f"blockdct refused the shape {plane.shape}")
    COUNT.n += 1
    return out
