"""Differentiable JPEG pool (port of vwfd_tpu/attacks/jpeg.py:23-51,149-223).

``jpeg_pool`` is one draw from the reference's 15-member pool
``Combined([JpegMask(Q), Jpeg(Q), JpegSS(Q) for Q in 50..90])``
(models/IRNcrop_model.py:98-103); ``jpeg_pool_pair`` is
``w1·jpeg_pool(draw 1) + w2·jpeg_pool(draw 2)`` with the colour transform,
DCT and IDCT run once, through K5 (``kernels/jpeg.py``). The draws are
explicit tensors: the quality index into ``QUALITIES`` and the mode, 0 hard
round, 1 x³ soft round, 2 zonal 5×5/3×3 keep. Quality Q means the table
scale 2 − 0.02·Q (Q ≥ 50). ``jpeg_real`` is the real libjpeg round trip
(``:261-280``), on the host through PIL, the evaluation's oracle.

``jpeg_basic`` (``:53-90``) is MBRS's JPEG: one draw of the pool at mode 0
or 1, through K5 with weights (1, 0). ``jpeg_pool_draw`` is one draw of
the pool at any quality value and mode for a whole batch, through K5 the
same way: the JAX ``jpeg_pool(key, img, qualities)`` of Tianchi's QF
bands (``quality_tables`` builds tables from quality values, Q < 50
scaling by 50/Q).

``jpeg_basic(subsample=2)`` takes 4:2:0 chroma (``:67-75``) through K5's
4:2:0 mode; ``jpeg_mask`` (``:93-107``) is JpegMask, one draw of K5 in its
zonal mode 2 (the quality is accepted and ignored, as the reference's).

``diffjpeg`` (``:114-146``) is the reference's DiffJPEG (utils/JPEG.py:
501-540): DiffJPEG YCbCr, 2×2-mean chroma, centred DCT, the transposed
tables times the quality factor, the x³ soft round, JAX's clip, through
K24 (``kernels/diffjpeg.py``). ``diffjpeg_pool`` (``:226-234``) is one draw
of ``Combined([DiffJPEG(Q) for Q in (60, 70, 80, 90)])``, the quality
index an explicit tensor (``sample_diffjpeg_index`` draws it).

``hidden_jpeg_mask_compression`` (``:249-258``) is HiDDeN's JpegCompression:
analog YUV, blockwise DCT, the zig-zag keep masks (``zigzag_keep_mask``,
``:236-246``; 25 / 9 / 9 coefficients), IDCT and back, with the clip of
``vwfd_tpu/models/hidden_model.py:40-42`` as an option, through K16
(``kernels/zigzag.py``).
"""

import numpy as np
import torch

from ..ops.color import rgb_to_yuv_jpegbasic, yuv_to_rgb_jpegbasic
from ..ops.dct import (C_TABLE, Y_TABLE, block_merge, block_split,
                       dct_blocks, idct_blocks, zigzag_keep_mask)
from ..ops.quantize import (jpeg_scale_factor, quality_to_factor,
                             round_only_at_0)

__all__ = ["Y_TABLE", "C_TABLE", "QUALITIES", "DIFFJPEG_QUALITIES",
           "quant_tables", "quality_tables", "jpeg_pool", "jpeg_pool_draw",
           "jpeg_pool_pair", "jpeg_basic", "jpeg_mask", "diffjpeg",
           "diffjpeg_pool", "sample_diffjpeg_index", "jpeg_real",
           "zigzag_keep_mask", "hidden_jpeg_mask_compression"]

QUALITIES = (50, 60, 70, 80, 90)
DIFFJPEG_QUALITIES = (60, 70, 80, 90)  # diffjpeg_pool's (IRNcrop_model:104)


def quality_tables(q: torch.Tensor) -> torch.Tensor:
    """Quality values (...) float32, any quality (Q < 50 scales the tables
    by 50/Q) → tables (..., 2 (Y, C), 8, 8) float32: ``max(round(T·scale),
    1)`` with the JAX package's float32 ops (``jpeg.py:149-180``)."""
    scale = jpeg_scale_factor(q.float())[..., None, None, None]
    tabs = torch.from_numpy(np.stack([Y_TABLE, C_TABLE])).to(q.device)
    return torch.clamp(torch.round(tabs * scale), min=1.0)


def _quality(q_idx: torch.Tensor) -> torch.Tensor:
    return torch.tensor(QUALITIES, dtype=torch.float32,
                        device=q_idx.device)[q_idx]


def quant_tables(q_idx: torch.Tensor) -> torch.Tensor:
    """Quality indices (...) into ``QUALITIES`` → ``quality_tables`` of
    those qualities."""
    return quality_tables(_quality(q_idx))


def jpeg_pool(img: torch.Tensor, q_idx: torch.Tensor, mode: torch.Tensor
              ) -> torch.Tensor:
    """One pool draw per frame of (N, H, W, 3): quality index and mode
    (N,) each."""
    n = img.shape[0]
    yuv = rgb_to_yuv_jpegbasic(img * 255.0)
    coeff = dct_blocks(block_split(yuv.movedim(-1, -3)))
    q = quant_tables(q_idx)[:, [0, 1, 1], None, None]
    m = mode.view(n, 1, 1, 1, 1, 1)
    scaled = coeff / q
    quantized = torch.where(m == 0, torch.round(scaled),
                            round_only_at_0(scaled)) * q
    from ..kernels.jpeg import zonal_mask
    zm = zonal_mask(img.device)[:, None, None]
    out = torch.where(m == 2, coeff * zm, quantized)
    rgb = yuv_to_rgb_jpegbasic(block_merge(idct_blocks(out)).movedim(-3, -1))
    return rgb / 255.0


def jpeg_pool_pair(img: torch.Tensor, q_idx: torch.Tensor,
                   mode: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   kernels=None) -> torch.Tensor:
    """``w1·jpeg_pool(draw 1) + w2·jpeg_pool(draw 2)`` per frame of
    (N, H, W, 3), exactly, with one DCT and one IDCT: the dequantised
    coefficients are mixed, (w1·c1 + w2·c2)/(w1 + w2), and the RGB scaled
    by w1 + w2 (IDCT is linear, YUV→RGB affine). ``q_idx`` and ``mode`` are
    (N, 2); ``w1``, ``w2`` (N,). Runs ``kernels.jpeg_pair`` (K5; default
    ``kernels.KERNELS``)."""
    if kernels is None:
        from ..kernels import KERNELS as kernels
    qt = quant_tables(q_idx).contiguous()
    w = torch.stack([w1, w2], -1).float().contiguous()
    return kernels.jpeg_pair(img, qt, mode.to(torch.int32).contiguous(), w)


def jpeg_pool_draw(img: torch.Tensor, quality, mode, kernels=None,
                   subsample: int = 0) -> torch.Tensor:
    """One draw of the JAX ``jpeg_pool(key, img, qualities)`` for the whole
    batch (N, H, W, 3), H and W multiples of 8, at the drawn quality
    *value* ``quality`` (any, e.g. Tianchi's band 40-55) and ``mode`` (0
    hard round, 1 x³ soft round, 2 zonal keep), each a number, a 0-dim
    tensor or one per frame: K5 ``jpeg_pair`` (default
    ``kernels.KERNELS``) with both draws set to it and weights (1, 0),
    which is the draw exactly (see ``jpeg_basic``), differentiable in
    img; ``subsample=2`` takes 4:2:0 chroma (modes 0 and 1)."""
    if kernels is None:
        from ..kernels import KERNELS as kernels
    n, dev = img.shape[0], img.device
    q = torch.as_tensor(quality, dtype=torch.float32, device=dev)
    qt = quality_tables(q.reshape(-1, 1).expand(n, 2)).contiguous()
    m = torch.as_tensor(mode, dtype=torch.int32, device=dev).reshape(
        -1, 1).expand(n, 2).contiguous()
    w = torch.tensor([1.0, 0.0], device=dev,
                     dtype=torch.float32).expand(n, 2).contiguous()
    return kernels.jpeg_pair(img, qt, m, w, subsample=subsample)


_ROUNDING = {"round": 0, "ss": 1}  # jpeg_pair's modes


def jpeg_basic(img: torch.Tensor, q_idx: torch.Tensor,
               rounding: str = "round", subsample: int = 0,
               kernels=None) -> torch.Tensor:
    """The reference's Jpeg / JpegSS (``vwfd_tpu/attacks/jpeg.py:53-90``)
    of (N, H, W, 3) float32 in [0, 1], H and W multiples of 8: YUV of
    255·img (``rgb_to_yuv_jpegbasic``), the un-centred blockwise DCT,
    division by the tables ``max(round(T·s), 1)`` of the quality indices
    ``q_idx`` ((N,) or one, into ``QUALITIES``; s = 2 − 0.02·Q), ``rint``
    (``"round"``) or the x³ soft round (``"ss"``), the tables back, IDCT,
    RGB, /255; differentiable in img.

    This is one draw of ``jpeg_pool`` at mode 0 or 1, so it runs
    ``kernels.jpeg_pair`` (K5; default ``kernels.KERNELS``) unchanged: both
    draws carry the quality and the mode, the weights are (1, 0), and K5's
    mix ``(1·d + 0·d)/1`` is ``d`` and its ``(w1 + w2)·rgb/255`` is
    ``rgb/255``, exactly (both in its plain version too, which a CPU tensor
    takes). ``subsample=2`` is the reference's 4:2:0 chroma (each 8×8
    block's chroma taken from the even row and column of each 2×2, before
    the DCT), K5's 4:2:0 mode."""
    if subsample not in (0, 2):
        raise ValueError(f"subsample must be 0 or 2, got {subsample!r}")
    if rounding not in _ROUNDING:
        raise ValueError(f"rounding must be 'round' or 'ss', got {rounding!r}")
    q = _quality(torch.as_tensor(q_idx, device=img.device))
    return jpeg_pool_draw(img, q, _ROUNDING[rounding], kernels, subsample)


def jpeg_mask(img: torch.Tensor, quality=None, kernels=None) -> torch.Tensor:
    """JpegMask (``vwfd_tpu/attacks/jpeg.py:93-107``) of (N, H, W, 3)
    float32 in [0, 1], H and W multiples of 8: the jpegbasic YUV, the
    blockwise DCT, Y's 5×5 and chroma's 3×3 low frequencies kept, no
    quantisation, back: K5's zonal mode 2, one draw with weights (1, 0).
    ``quality`` is accepted and ignored, as in the reference."""
    del quality
    return jpeg_pool_draw(img, 50.0, 2, kernels)


def _factors(n: int, factor, device) -> torch.Tensor:
    f = torch.as_tensor(factor, dtype=torch.float32, device=device)
    return f.reshape(-1).expand(n).contiguous()


def diffjpeg(img: torch.Tensor, quality=None, *, factor=None, kernels=None
             ) -> torch.Tensor:
    """DiffJPEG (``vwfd_tpu/attacks/jpeg.py:114-146``) of (..., H, W, 3)
    float32 in [0, 1], H and W multiples of 16, at ``quality`` (a number)
    or ``factor`` (a number, a 0-dim tensor or one per frame); through
    ``kernels.diffjpeg`` (K24; default ``kernels.KERNELS``),
    differentiable in img."""
    if kernels is None:
        from ..kernels import KERNELS as kernels
    if factor is None:
        factor = quality_to_factor(quality)
    x = img.reshape((-1,) + tuple(img.shape[-3:])).contiguous()
    out = kernels.diffjpeg(x, _factors(x.shape[0], factor, x.device))
    return out.reshape(img.shape)


def sample_diffjpeg_index(generator: torch.Generator,
                          qualities=DIFFJPEG_QUALITIES) -> torch.Tensor:
    """``diffjpeg_pool``'s draw: one uniform quality index (a 0-dim int64
    tensor on the generator's device)."""
    return torch.randint(0, len(qualities), (), generator=generator,
                         device=generator.device)


def diffjpeg_pool(img: torch.Tensor, q_idx, qualities=DIFFJPEG_QUALITIES,
                  kernels=None) -> torch.Tensor:
    """One draw of ``Combined([DiffJPEG(Q) for Q in qualities])``
    (``vwfd_tpu/attacks/jpeg.py:226-234``, models/IRNcrop_model.py:104):
    the quality ``qualities[q_idx]`` (an explicit index, a number or a
    tensor, one for the call or one per frame) enters as DiffJPEG's factor
    in float32, as the JAX package's traced draw."""
    qs = torch.tensor(qualities, dtype=torch.float32, device=img.device)
    q = qs[torch.as_tensor(q_idx, device=img.device)]
    return diffjpeg(img, factor=quality_to_factor(q), kernels=kernels)


def hidden_jpeg_mask_compression(img: torch.Tensor, yuv_keep=(25, 9, 9),
                                  clip: bool = False, kernels=None
                                  ) -> torch.Tensor:
    """HiDDeN's JPEG-mask compression of (N, H, W, 3) float32, H and W
    multiples of 8, any scale; with ``clip`` the result is clipped to
    [0, 1] (``jnp.clip``: gradient ½ at the ends). Runs
    ``kernels.zigzag_jpeg`` (K16; default ``kernels.KERNELS``)."""
    if kernels is None:
        from ..kernels import KERNELS as kernels
    return kernels.zigzag_jpeg(img, tuple(yuv_keep), clip)


def jpeg_real(img01: np.ndarray, quality: int, subsampling: int = 0
              ) -> np.ndarray:
    """Real libjpeg round trip through PIL (port of
    vwfd_tpu/attacks/jpeg.py:261-280): the non-differentiable oracle the
    reference calls ``JpegTest``. Host only, numpy in and out: frames (H, W,
    3) or (N, H, W, 3) in [0, 1], each rounded to uint8, encoded at
    ``quality`` with chroma ``subsampling`` and decoded, back in [0, 1].
    PIL is imported here, not with the module: without it this raises an
    ``ImportError`` that names it."""
    import io
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("jpeg_real needs PIL (Pillow) for libjpeg, and it "
                          "does not import here") from e

    x = np.asarray(img01)
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    out = np.empty_like(x)
    for i in range(x.shape[0]):
        u8 = (np.clip(x[i], 0, 1) * 255).round().astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(u8).save(buf, format="JPEG", quality=int(quality),
                                 subsampling=subsampling)
        out[i] = np.asarray(Image.open(buf), np.float32) / 255.0
    return out[0] if squeeze else out
