"""Attacks of the port (counterparts of vwfd_tpu/attacks): the flagship
video pool and its members, HiDDeN's noise members, MBRS's JPEG,
Tianchi's banded pool draw and the image family's copy-move tamper, every
random draw an explicit tensor or number."""

from .blur import gaussian_blur_attack, gf_attack, median_blur_attack
from .combined import (ATTACK_POOL_SIZE, AttackDraws, attack_pool_video,
                       combined_switch, sample_attack_draws,
                       sample_switch_index)
from .jpeg import (diffjpeg, diffjpeg_pool, hidden_jpeg_mask_compression,
                   jpeg_basic, jpeg_mask, jpeg_pool, jpeg_pool_draw,
                   jpeg_pool_pair, jpeg_real, quality_tables, quant_tables,
                   sample_diffjpeg_index, zigzag_keep_mask)
from .noise import dropout_pixelwise, gaussian_noise, identity, salt_pepper
from .spatial import (DEFAULT_RATIOS, copy_move_shift, copy_move_tamper,
                      crop_attack, cropout, dropout_mix, shift_zero_pad,
                      rect_mask, resize_roundtrip, sample_crop_apex)

__all__ = ["gaussian_blur_attack", "median_blur_attack", "gf_attack",
           "ATTACK_POOL_SIZE", "AttackDraws", "attack_pool_video",
           "sample_attack_draws", "combined_switch", "sample_switch_index",
           "jpeg_pool", "jpeg_pool_draw", "jpeg_pool_pair", "jpeg_basic",
           "jpeg_mask", "diffjpeg", "diffjpeg_pool", "sample_diffjpeg_index",
           "jpeg_real", "quant_tables", "quality_tables",
           "DEFAULT_RATIOS", "resize_roundtrip",
           "hidden_jpeg_mask_compression", "zigzag_keep_mask", "identity",
           "gaussian_noise", "salt_pepper", "dropout_pixelwise",
           "sample_crop_apex", "crop_attack", "rect_mask", "cropout",
           "dropout_mix", "shift_zero_pad", "copy_move_shift",
           "copy_move_tamper"]
