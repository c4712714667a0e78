"""Binary mask morphology: dilate, erode, closing, opening (port of
vwfd_tpu/ops/morphology.py; the reference's noise_layers/__init__.py:24-81).

The structuring element is the cross of the 4 neighbours without the
centre, under edge padding, iterated ``iterations`` times, on masks in
[0, 1] of shape (..., H, W) or (..., H, W, 1). Dilate sets a pixel when
any neighbour is set, erode clears it unless all are, each also keeping
the pixel's own value in the max / min, as the JAX package does; like it,
the whole image is processed (the reference's loops skip row and column 0).
"""

import torch

__all__ = ["dilate", "erode", "closing", "opening"]


def _neighbors4(x: torch.Tensor) -> torch.Tensor:
    """The 4 cross-neighbours of every pixel of (..., H, W), edge-padded,
    stacked on axis 0 (up, down, left, right)."""
    p = torch.cat([x[..., :1, :], x, x[..., -1:, :]], -2)
    p = torch.cat([p[..., :1], p, p[..., -1:]], -1)
    return torch.stack([p[..., :-2, 1:-1], p[..., 2:, 1:-1],
                        p[..., 1:-1, :-2], p[..., 1:-1, 2:]], 0)


def _spatial(fn):
    def wrapped(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
        squeeze = mask.dim() >= 3 and mask.shape[-1] == 1
        x = mask[..., 0] if squeeze else mask
        for _ in range(int(iterations)):
            x = fn(x)
        return x[..., None] if squeeze else x
    wrapped.__doc__ = fn.__doc__
    wrapped.__name__ = fn.__name__
    return wrapped


@_spatial
def dilate(x: torch.Tensor) -> torch.Tensor:
    """Pixel → 1 when any 4-neighbour is set."""
    return torch.maximum(x, _neighbors4(x).amax(0))


@_spatial
def erode(x: torch.Tensor) -> torch.Tensor:
    """Pixel → 0 unless all 4 neighbours are set."""
    return torch.minimum(x, _neighbors4(x).amin(0))


def closing(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Dilate, then erode."""
    return erode(dilate(mask, iterations), iterations)


def opening(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Erode, then dilate."""
    return dilate(erode(mask, iterations), iterations)
