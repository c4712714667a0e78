"""Device resolution for the port's entry points.

Entry points run on a CUDA card unless the caller asks for the CPU by
name: ``"cuda"`` is the current card, ``"cuda:N"`` card N (a data-parallel
rank takes ``cuda:LOCAL_RANK``, ``parallel.local_device``; a server may
drive several, ``WatermarkServer(devices=...)``). There is no silent
fallback: with no card and no explicit ``"cpu"`` they raise.
"""

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``, the current card (raises without one);
    otherwise the named device, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vwfd_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``TrainConfig.dtype`` → the compute dtype (params stay float32)."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return dtypes[name]


@contextlib.contextmanager
def full_f32():
    """Float32 convolutions and matrix products in full float32 on the card:
    cuDNN's and cuBLAS's TF32 off inside, the caller's settings restored
    after (TF32 keeps about three decimal digits)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = prev
