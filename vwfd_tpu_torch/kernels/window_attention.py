"""K18 `window_attention`: SUNet's (shifted-)window attention, forward and
backward with respect to the qkv projection and the relative-position table.

Replaces no Pallas kernel: the JAX package's ``vwfd_tpu/nets/sunet.py::
WindowAttention`` (:32-71) is a hand-shaped op that XLA lowers (window
partition by reshape, a gather of the relative-position bias, the additive
shift mask, einsum → softmax → einsum). K18 is the body of its
``__call__`` between the ``qkv`` Dense and ``proj``: per (window, head)
problem, ``softmax(q·kᵀ·d^-½ + B[h] + M[w]) · v``, B the bias gathered from
the ((2·ws − 1)², heads) table and M the shift mask of the window's
position in its image (:93-100), or none. It reads ``qkv`` in the Dense's
layout (nW·B, N, 3, heads, d) and writes (nW·B, N, heads·d), ready for
``proj``: nothing is transposed between them. Windows are ordered (image,
row, column), as ``window_partition`` makes them.

Shapes: N = ws² ≤ 64 (window ≤ 8) and d ∈ {16, 32, 64}, float32; a CUDA
tensor of any other shape or type raises (a CPU tensor takes the plain
version, any shape). At SUNet's published widths N = 64 and d = 32 at
every stage, heads 3, 6, 12, 24.

Bound: bytes, narrowly. At 256² b8 stage 0 (1,536 problems) the forward
reads qkv (37.7 MB) and writes 12.6 MB, 0.0150 ms at 3.35 TB/s, against
0.805 GFLOP of products, 0.012 ms at the card's 67 TFLOP/s of float32 FMA
(H100 SXM data sheet, 700 W).

Design (``csrc/window_attention.cu``): one CTA of 128 threads a (window,
head) problem, q, k and v (and dO) in shared memory, every product of the
N × N and N × d tiles from registers in float32 (4 rows × 8 columns a
thread); the mask is computed in the kernel from the window's row, column
and shift (3 × 3 regions of the rolled map), never read from memory. The
backward recomputes S and P, forms dS = P ∘ (dP − rowsum(P ∘ dP)) and
writes dq, dk, dv in the qkv gradient's layout; the table's gradient (Σ of
dS over windows and images, scattered through the index) is summed per CTA
into the (2·ws − 1)² bins in a fixed order, then over the windows by a
second launch with a fixed tree: deterministic, no float atomics. Each
launch of the forward, and each backward (its two CUDA kernels), counts
one. Tensor cores (TF32 or bf16) are later work.
"""

import functools
from typing import Tuple

import numpy as np
import torch

from . import _lib

__all__ = ["window_attention", "window_attention_plain", "relative_index",
           "shift_mask", "work", "COUNT", "HEAD_DIMS", "MAX_WINDOW"]

COUNT = _lib.LaunchCount("window_attention")

HEAD_DIMS = (16, 32, 64)
MAX_WINDOW = 8  # N = ws² ≤ 64


@functools.lru_cache(maxsize=None)
def relative_index(ws: int) -> np.ndarray:
    """(ws², ws²) int64: the table row of each (query, key) pair,
    ``(Δrow + ws − 1)·(2·ws − 1) + Δcol + ws − 1`` (sunet.py:52-57)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + ws - 1
    return rel[0] * (2 * ws - 1) + rel[1]


@functools.lru_cache(maxsize=None)
def shift_mask(ws: int, h: int, w: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) float32: the JAX block's additive mask of a map of
    h × w tokens rolled by ``shift`` (sunet.py:93-100): −100 where the
    query and key lie in different regions, else 0."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    return np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0
                    ).astype(np.float32)


def _window(n: int) -> int:
    ws = int(round(n ** 0.5))
    if ws * ws != n:
        raise ValueError(f"window_attention: {n} tokens a window is not a "
                         f"square window")
    return ws


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           grid: Tuple[int, int], shift: int = 0
                           ) -> torch.Tensor:
    """Plain PyTorch version, JAX's order of operations: einsum, ×d^-½,
    + bias, + mask, softmax, einsum (gradients by autograd). ``qkv`` (nW·B,
    N, 3, heads, d), ``table`` ((2·ws − 1)², heads), ``grid`` the windows
    of one image (rows, columns), ``shift`` 0 for no mask; returns (nW·B,
    N, heads·d) in ``qkv``'s dtype (float32, or float64 for the CPU parity
    tests)."""
    bnw, n, _, h, d = qkv.shape
    ws = _window(n)
    q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    idx = torch.from_numpy(relative_index(ws).reshape(-1)).to(qkv.device)
    bias = table[idx].reshape(n, n, h).permute(2, 0, 1)[None]
    attn = torch.einsum("bhnd,bhmd->bhnm", q, k) * d ** -0.5 + bias
    if shift:
        nh, nw = grid
        mask = torch.from_numpy(shift_mask(ws, nh * ws, nw * ws, shift)).to(
            device=qkv.device, dtype=qkv.dtype)
        attn = (attn.reshape(bnw // (nh * nw), nh * nw, h, n, n)
                + mask[None, :, None]).reshape(bnw, h, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
    return out.transpose(1, 2).reshape(bnw, n, h * d)


def _check(qkv: torch.Tensor, table: torch.Tensor, grid, shift: int) -> None:
    """Raise unless K18 takes these."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"window_attention: qkv must be (nW·B, N, 3, heads, "
                         f"d), got {tuple(qkv.shape)}")
    bnw, n, _, h, d = qkv.shape
    ws = _window(n)
    if qkv.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"the window_attention kernel takes float32, got "
                        f"{qkv.dtype} and {table.dtype}")
    if ws > MAX_WINDOW or d not in HEAD_DIMS:
        raise ValueError(f"the window_attention kernel takes windows up to "
                         f"{MAX_WINDOW} (N ≤ 64) and d in {HEAD_DIMS}, got "
                         f"N = {n}, d = {d}")
    if tuple(table.shape) != ((2 * ws - 1) ** 2, h):
        raise ValueError(f"window_attention: table must be "
                         f"({(2 * ws - 1) ** 2}, {h}), got "
                         f"{tuple(table.shape)}")
    nh, nw = grid
    if nh < 1 or nw < 1 or bnw % (nh * nw) or not 0 <= shift < ws:
        raise ValueError(f"window_attention: {bnw} windows do not fill "
                         f"images of {nh} × {nw} windows, or shift {shift} "
                         f"is outside [0, {ws})")


class _WindowAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, table, grid, shift):
        bnw, n, _, h, d = qkv.shape
        out = torch.empty((bnw, n, h * d), device=qkv.device,
                          dtype=qkv.dtype)
        ctx.args = (bnw, _window(n), h, d, grid[0], grid[1], shift,
                    d ** -0.5)
        _lib.launch("vwfd_window_attention_fwd", qkv.device, qkv.data_ptr(),
                    table.data_ptr(), out.data_ptr(), *ctx.args)
        COUNT.n += 1
        ctx.save_for_backward(qkv, table)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, table = ctx.saved_tensors
        g = g.contiguous()
        bnw, ws, h = ctx.args[:3]
        dqkv = torch.empty_like(qkv)
        dtable = torch.empty_like(table)
        part = torch.empty(h * (2 * ws - 1) ** 2 * bnw, device=qkv.device,
                           dtype=torch.float32)
        _lib.launch("vwfd_window_attention_bwd", qkv.device, qkv.data_ptr(),
                    table.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                    part.data_ptr(), dtable.data_ptr(), *ctx.args)
        COUNT.n += 1
        return dqkv, dtable, None, None


def window_attention(qkv: torch.Tensor, table: torch.Tensor,
                     grid: Tuple[int, int], shift: int = 0) -> torch.Tensor:
    """Window attention of ``qkv`` (nW·B, N, 3, heads, d) with the
    relative-position ``table`` ((2·ws − 1)², heads), the windows of one
    image ``grid`` = (rows, columns) and the block's ``shift`` (0: no
    mask); returns (nW·B, N, heads·d), differentiable in both. K18 for
    CUDA tensors, the plain version for CPU tensors."""
    if not _lib.on_cuda(qkv, table):
        return window_attention_plain(qkv, table, grid, shift)
    qkv = qkv.contiguous()
    table = table.contiguous()
    _check(qkv, table, grid, shift)
    _lib.check_aligned(qkv, "window_attention qkv")
    return _WindowAttentionFn.apply(qkv, table, tuple(grid), int(shift))


def work(qkv_shape, backward: bool = False) -> Tuple[int, int]:
    """(bytes, flops) the function needs at ``qkv_shape``: the forward reads
    qkv and the table and writes the output, and does the two N × N × d
    products; the backward reads qkv, the table and dO and writes dqkv and
    the table's gradient, and does four (dP and the three gradients; the
    kernel also recomputes S, which the least work does not count)."""
    bnw, n, _, h, d = qkv_shape
    ws = _window(n)
    qkv_b = bnw * n * 3 * h * d * 4
    out_b = bnw * n * h * d * 4
    tab_b = (2 * ws - 1) ** 2 * h * 4
    prod = 2 * bnw * h * n * n * d
    if not backward:
        return qkv_b + out_b + tab_b, 2 * prod
    return 2 * qkv_b + out_b + 2 * tab_b, 4 * prod

