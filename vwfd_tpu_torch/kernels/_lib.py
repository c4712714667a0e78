"""Build, load and call the port's hand-written CUDA kernels.

Every source under ``vwfd_tpu_torch/csrc`` is compiled for ``sm_90a`` by its
own ``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
library is built at first use into ``build/vwfd_tpu_torch/`` at the root of
the checkout (a directory ``.gitignore`` lists); its file name carries a
hash of the sources, so an edited source is rebuilt and a stale library is
never loaded. Nothing is built or loaded at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vwfd_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_U64 = ctypes.c_ulonglong
_FP = ctypes.POINTER(ctypes.c_float)  # a host array of floats
_IP = ctypes.POINTER(ctypes.c_int)  # a host array of ints
# The C interface, one entry per exported function: argtypes (a launcher's
# trailing void* is the CUDA stream); every launcher returns a cudaError_t as
# int (vwfd_window_attention_ctas and vwfd_canny_geometry, no launchers,
# return counts).
_SIGNATURES = {
    "vwfd_transition": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_coupling_head": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I,
                           _I, _I, _I, _I, _P],
    "vwfd_wire_to_channels": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_wire_to_u8": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_wire_to_s2d": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_wire_to_u8_s2d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_mask_pack": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                       _I, _I, _P],
    "vwfd_jpeg_pair_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vwfd_jpeg_pair_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vwfd_median3_fwd": [_P, _P, _I, _I, _I, _P],
    "vwfd_median3_bwd": [_P, _P, _P, _I, _I, _I, _P],
    "vwfd_f1_sweep": [_P, _P, _L, _FP, _I, _I, _I, _P, _P, _P, _P],
    "vwfd_ssim": [_P, _P, _I, _I, _I, _I, _I, _FP, _P, _P, _P, _P, _P, _P],
    "vwfd_attack_mix_fwd": [_P, _P, _P, _P, _P, _P, _FP, _I, _I, _I, _I, _P],
    "vwfd_attack_mix_bwd": [_P, _P, _P, _P, _P, _FP, _I, _I, _I, _P],
    "vwfd_splice_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vwfd_splice_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vwfd_wire_to_u8_s2d_i8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_qconv": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P,
                   _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                   _I, _P],
    "vwfd_qconv_t": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _P],
    "vwfd_qcoupling_head": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                            _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    "vwfd_haar": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_coupling_affine": [_P, _I, _P, _I, _P, _I, _P, _I, _L, _I, _I, _I,
                             _I, _P],
    "vwfd_coupling_affine_bwd": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P,
                                 _I, _P, _I, _L, _I, _I, _I, _I, _P],
    "vwfd_zigzag_jpeg": [_P, _P, _P, _P, _U64, _U64, _U64, _I, _I, _I, _I,
                         _I, _P],
    "vwfd_crop_resize_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_crop_resize_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    "vwfd_window_attention_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _F, _P],
    "vwfd_window_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _F, _P],
    "vwfd_window_attention_ctas": [_I, _I],
    "vwfd_canny_geometry": [_IP],
    "vwfd_crop_cubic_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    "vwfd_crop_cubic_bwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    "vwfd_rectify": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vwfd_rectify_bwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vwfd_ssim_grad": [_P, _P, _P, _FP, _P, _I, _I, _I, _I, _I, _P],
    "vwfd_canny_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vwfd_canny_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _I, _I, _P],
    "vwfd_film_fwd": [_P, _P, _P, _P, _P, _L, _L, _P],
    "vwfd_film_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _P],
    "vwfd_diffjpeg_fwd": [_P, _P, _P, _I, _I, _I, _P],
    "vwfd_diffjpeg_bwd": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None          # the loaded library, one per process
build_seconds = None  # wall time of the nvcc call, if this process built it


class LaunchCount:
    """Launches of one kernel's CUDA code. A wrapper adds one where it
    launches its kernel and nowhere else; the plain path is not counted."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvwfd_kernels_{h.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for every ``(cmd, Popen)``; raise with the output of the first
    that failed."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, out, err)
    if failed:
        rc, cmd, out, err = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}{err}")


def build() -> Path:
    """Compile each ``csrc/*.cu`` in its own ``nvcc`` process, all at once,
    then link them into one library (no-op when the library for these
    sources exists). Returns the library's path."""
    global build_seconds
    out = library_path()
    if out.is_file():
        return out
    objdir = out.with_name(f"{out.stem}.{os.getpid()}.obj")
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = objdir / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
        objs.append(str(obj))
    _run(procs)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))])
    os.replace(tmp, out)  # atomic: concurrent builders never see a half file
    shutil.rmtree(objdir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C interface."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vwfd_error_string.argtypes = [ctypes.c_int]
            lib.vwfd_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call one C launcher on the current stream of ``device``, with
    ``device`` the thread's current device (a launcher's attribute calls
    and launches act on the current device: a server driving two cards
    must not launch one card's tensors on the other), and raise if the
    launch was refused."""
    lib = load()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.vwfd_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")


def stream_scratch(cache: dict, dev: torch.device, specs):
    """Scratch tensors of the current stream on ``dev``, kept in ``cache``
    from call to call: one per ``(numel, dtype, zeroed)`` of ``specs``,
    reallocated only when it must grow (a grown ``zeroed`` one starts at
    0). A kernel that keeps tickets here must leave them at 0. Launches on
    one stream run one after another, so they never share the scratch at
    the same time."""
    key = dev, torch.cuda.current_stream(dev).cuda_stream
    old = cache.get(key, [None] * len(specs))
    new = [t if t is not None and t.numel() >= n else
           (torch.zeros if zeroed else torch.empty)(n, device=dev, dtype=dt)
           for t, (n, dt, zeroed) in zip(old, specs)]
    cache[key] = new
    return new


_SMS: dict = {}  # streaming multiprocessors per device index


def sm_count(dev: torch.device) -> int:
    """The card's SM count, queried once per device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}"
                        ) from None


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU (the plain path); raises for anything else."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, kinds))}")
    dev = kinds.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}")


def check_aligned(t: torch.Tensor, name: str, row_stride: int = 0) -> None:
    """Raise unless ``t`` starts on a 16-byte boundary and its rows (of
    ``row_stride`` elements) keep it: the kernels' vector accesses."""
    if t.data_ptr() % 16 or (row_stride * t.element_size()) % 16:
        raise ValueError(f"{name}: base address and row stride must be "
                         f"16-byte aligned (address {t.data_ptr():#x}, row "
                         f"stride {row_stride} elements)")


def check_nhwc(t: torch.Tensor, name: str, ndim: int = 4) -> None:
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
