"""Networks of the port (counterparts of vwfd_tpu/nets)."""

from .inn import InvertibleNet, RNVPCoupling, ResSubnetTPU, ResSubnetTPUS2
from .unet import UNetTPU

__all__ = ["InvertibleNet", "RNVPCoupling", "ResSubnetTPU", "ResSubnetTPUS2",
           "UNetTPU"]
