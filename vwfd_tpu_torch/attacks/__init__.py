"""Attacks of the port (counterparts of vwfd_tpu/attacks): the flagship
video pool and its members, every random draw an explicit tensor."""

from .blur import gaussian_blur_attack, median_blur_attack
from .combined import (ATTACK_POOL_SIZE, AttackDraws, attack_pool_video,
                       sample_attack_draws)
from .jpeg import jpeg_pool, jpeg_pool_pair, jpeg_real, quant_tables
from .spatial import DEFAULT_RATIOS, resize_roundtrip

__all__ = ["gaussian_blur_attack", "median_blur_attack", "ATTACK_POOL_SIZE",
           "AttackDraws", "attack_pool_video", "sample_attack_draws",
           "jpeg_pool", "jpeg_pool_pair", "jpeg_real", "quant_tables",
           "DEFAULT_RATIOS", "resize_roundtrip"]
