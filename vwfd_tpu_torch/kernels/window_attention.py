"""K18 `window_attention`: SUNet's (shifted-)window attention on the map,
forward and backward with respect to the qkv projection and the
relative-position table.

Replaces no Pallas kernel: the JAX package's ``vwfd_tpu/nets/sunet.py::
SwinBlock`` (:86-108) rolls the normalised map by −shift, cuts it into
windows (``window_partition``), runs ``WindowAttention`` (:32-71: the
``qkv`` Dense, a gather of the relative-position bias, the additive shift
mask, einsum → softmax → einsum, ``proj``), puts the windows back
(``window_reverse``) and rolls back; XLA lowers each step. The Dense layers
work token by token, so they commute with the moves: K18 takes ``qkv`` on
the map, (B, Hm, Wm, 3, heads, d), reads window (b, wy, wx)'s token (r, c)
from map position ((wy·ws + r + shift) mod Hm, (wx·ws + c + shift) mod Wm)
and writes its output, (B, Hm, Wm, heads·d), at the same position, ready
for ``proj``. Per (window, head) problem it computes
``softmax(q·kᵀ·d^-½ + B[h] + M[w]) · v``, B the bias gathered from the
((2·ws − 1)², heads) table and M the shift mask of the window's place in
the rolled map (:93-100), or none. No roll, partition or reverse is left
around it.

Shapes: windows ws ≤ 8 (N = ws² ≤ 64) that tile the map, d ∈ {16, 32,
64}, float32; a CUDA tensor of any other shape or type raises (a CPU
tensor takes the plain version, any shape). At SUNet's published widths
ws = 8 and d = 32 at every stage, heads 3, 6, 12, 24.

Bound: bytes. At 256² b8 stage 0 (1,536 problems) the forward reads qkv
(37.7 MB) and writes 12.6 MB, 0.0150 ms at 3.35 TB/s; its 0.805 GFLOP of
products would take 0.012 ms at the card's 67 TFLOP/s of float32 FMA and
take 0.0049 ms at its 495 TFLOP/s of TF32 three times over (H100 SXM data
sheet, 700 W).

Design (``csrc/window_attention.cu``, second version): the products on
the tensor cores to float32 accuracy, 3×TF32 (``hi = tf32_rna(x)``, ``lo =
tf32_rna(x − hi)``, 0 where ``hi`` is not finite; ``hi·hi + hi·lo +
lo·hi`` into float32). At d = 32, SUNet's, every product is a Hopper
``wgmma`` of one warpgroup (``m64n64k8`` / ``m64n32k8`` ``.tf32``), its
shared-memory operands in the 128-byte swizzle: the token-major tiles as
``cp.async`` writes them, and d-major tiles that the CTA's split writes for
the products that reduce over tokens; d = 16 and 64 run ``mma.sync
m16n8k8`` from XOR-swizzled split tiles. One warp holds 16 query rows, S,
P, dP and dS in registers; P and dS reach the next product straight from
the accumulator fragments (k permuted to match) or, for Pᵀ·dO and dSᵀ·q,
through one shared tile. Persistent CTAs (as many as the card holds at
once, ``vwfd_window_attention_ctas``) each take a fixed run of problems,
ordered head by head, and copy the next problem while computing the
current one. The mask is computed in the kernel from the window's place,
never read. The backward recomputes S and P, forms dS = P ∘ (dP −
rowsum(P ∘ dP)) and writes dq, dk, dv in the qkv gradient's layout; the
table's gradient is summed per CTA over its problems of a head in
registers, binned once per head into a scratch row, and the last CTA to
finish a head (an integer ticket) sums its rows in CTA order:
deterministic, no float atomics, one launch. Each launch of the forward,
and of the backward, counts one. Where the time goes and what the parts
cost: ``port_tools/ablate_window_attention.py``.
"""

import functools
from typing import Tuple

import numpy as np
import torch

from . import _lib

__all__ = ["window_attention", "window_attention_plain", "relative_index",
           "shift_mask", "window_partition", "window_reverse", "work",
           "COUNT", "HEAD_DIMS", "MAX_WINDOW"]

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


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nH·nW, ws, ws, C), windows ordered (image, row,
    column) (sunet.py:19-23)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """The inverse of ``window_partition`` (sunet.py:26-29)."""
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _windows_plain(qkv: torch.Tensor, table: torch.Tensor,
                   grid: Tuple[int, int], shift: int) -> torch.Tensor:
    """The attention of partitioned windows, JAX's order of operations:
    einsum, ×d^-½, + bias, + mask, softmax, einsum. ``qkv`` (nW·B, N, 3,
    heads, d), ``grid`` the windows of one image; returns (nW·B, N,
    heads·d)."""
    bnw, n, _, h, d = qkv.shape
    ws = int(round(n ** 0.5))
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


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           ws: int, shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version in JAX's order of operations: roll by −shift,
    ``window_partition``, the window attention, ``window_reverse``, roll
    back (gradients by autograd). ``qkv`` (B, Hm, Wm, 3, heads, d) on the
    map, ``table`` ((2·ws − 1)², heads), ``ws`` the window, ``shift`` 0
    for no mask; returns (B, Hm, Wm, heads·d) in ``qkv``'s dtype (float32,
    or float64 for the CPU parity tests)."""
    b, hm, wm, _, h, d = qkv.shape
    x = qkv.reshape(b, hm, wm, 3 * h * d)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    wins = window_partition(x, ws).reshape(-1, ws * ws, 3, h, d)
    out = _windows_plain(wins, table, (hm // ws, wm // ws), shift)
    y = window_reverse(out.reshape(-1, ws, ws, h * d), ws, hm, wm)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y


def _check(qkv: torch.Tensor, table: torch.Tensor, ws: int,
           shift: int) -> None:
    """Raise unless K18 takes these."""
    if qkv.dim() != 6 or qkv.shape[3] != 3:
        raise ValueError(f"window_attention: qkv must be (B, Hm, Wm, 3, "
                         f"heads, d), got {tuple(qkv.shape)}")
    b, hm, wm, _, h, d = qkv.shape
    if qkv.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"the window_attention kernel takes float32, got "
                        f"{qkv.dtype} and {table.dtype}")
    if not 1 <= ws <= MAX_WINDOW or d not in HEAD_DIMS:
        raise ValueError(f"the window_attention kernel takes windows up to "
                         f"{MAX_WINDOW} (N ≤ 64) and d in {HEAD_DIMS}, got "
                         f"ws = {ws}, d = {d}")
    if tuple(table.shape) != ((2 * ws - 1) ** 2, h):
        raise ValueError(f"window_attention: table must be "
                         f"({(2 * ws - 1) ** 2}, {h}), got "
                         f"{tuple(table.shape)}")
    if hm % ws or wm % ws or not 0 <= shift < ws:
        raise ValueError(f"window_attention: windows of {ws} do not tile "
                         f"the {hm} × {wm} map, or shift {shift} is outside "
                         f"[0, {ws})")


_CTAS: dict = {}  # (device index, d, backward) → resident CTAs
_TICKETS: dict = {}  # the backward's per-head tickets, 0 between launches


def _ctas(dev: torch.device, d: int, backward: bool, problems: int) -> int:
    """The persistent grid: the CTAs the card holds at once, at most one a
    problem. Fixed for a card and shape, so the table gradient's order is
    too."""
    key = dev.index, d, backward
    if key not in _CTAS:
        with torch.cuda.device(dev):
            n = _lib.load().vwfd_window_attention_ctas(d, int(backward))
        if n <= 0:
            raise RuntimeError(f"vwfd_window_attention_ctas: CUDA error "
                               f"{-n}")
        _CTAS[key] = n
    return min(problems, _CTAS[key])


class _WindowAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, table, ws, shift):
        b, hm, wm, _, h, d = qkv.shape
        out = torch.empty((b, hm, wm, h * d), device=qkv.device,
                          dtype=qkv.dtype)
        problems = b * (hm // ws) * (wm // ws) * h
        ctx.geo = (b, hm, wm, ws, shift, h, d)
        ctx.problems = problems
        _lib.launch("vwfd_window_attention_fwd", qkv.device, qkv.data_ptr(),
                    table.data_ptr(), out.data_ptr(), *ctx.geo,
                    _ctas(qkv.device, d, False, problems), d ** -0.5)
        COUNT.n += 1
        ctx.save_for_backward(qkv, table)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, table = ctx.saved_tensors
        g = g.contiguous()
        ws, h, d = ctx.geo[3], ctx.geo[5], ctx.geo[6]
        ctas = _ctas(qkv.device, d, True, ctx.problems)
        dqkv = torch.empty_like(qkv)
        dtable = torch.empty_like(table)
        part = torch.empty(h * ctas * (2 * ws - 1) ** 2, device=qkv.device,
                           dtype=torch.float32)
        tickets, = _lib.stream_scratch(_TICKETS, qkv.device,
                                       [(h, torch.int32, True)])
        _lib.launch("vwfd_window_attention_bwd", qkv.device, qkv.data_ptr(),
                    table.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                    part.data_ptr(), tickets.data_ptr(), dtable.data_ptr(),
                    *ctx.geo, ctas, d ** -0.5)
        COUNT.n += 1
        return dqkv, dtable, None, None


def window_attention(qkv: torch.Tensor, table: torch.Tensor, ws: int,
                     shift: int = 0) -> torch.Tensor:
    """Window attention of ``qkv`` (B, Hm, Wm, 3, heads, d) on the map with
    the relative-position ``table`` ((2·ws − 1)², heads), windows of ``ws``
    and the block's ``shift`` (0: no mask); returns (B, Hm, Wm, heads·d) at
    the map's positions, differentiable in both. K18 for CUDA tensors, the
    plain version for CPU tensors."""
    if not _lib.on_cuda(qkv, table):
        return window_attention_plain(qkv, table, ws, shift)
    qkv = qkv.contiguous()
    table = table.contiguous()
    _check(qkv, table, ws, shift)
    _lib.check_aligned(qkv, "window_attention qkv")
    return _WindowAttentionFn.apply(qkv, table, int(ws), int(shift))


def work(qkv_shape, ws: int, backward: bool = False) -> Tuple[int, int]:
    """(bytes, flops) the function needs at ``qkv_shape`` (B, Hm, Wm, 3,
    heads, d) with windows of ``ws``: the forward reads qkv and the table
    and writes the output, and does the two N × N × d products; the
    backward reads qkv, the table and dO and writes dqkv and the table's
    gradient, and does four (dP and the three gradients; the kernel also
    recomputes S, which the least work does not count)."""
    b, hm, wm, _, h, d = qkv_shape
    n = ws * ws
    tokens = b * hm * wm
    qkv_b = tokens * 3 * h * d * 4
    out_b = tokens * h * d * 4
    tab_b = (2 * ws - 1) ** 2 * h * 4
    prod = 2 * tokens * h * n * d
    if not backward:
        return qkv_b + out_b + tab_b, 2 * prod
    return 2 * qkv_b + out_b + 2 * tab_b, 4 * prod

