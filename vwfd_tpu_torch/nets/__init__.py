"""Networks of the port (counterparts of vwfd_tpu/nets)."""

from .inn import (DenseSubnet, InvertibleNet, RNVPCoupling, ResSubnet,
                  ResSubnetTPU, ResSubnetTPUS2)
from .blocks import ConvBNRelu, ResnetBlock, SNConv
from .hidden import (HiddenDecoder, HiddenDiscriminator, HiddenEncoder,
                     HiddenEncoderDecoder)
from .mbrs import (BalujaHiding, BalujaPrep, BalujaReveal, ExpandNet,
                   MBRSDecoder, MBRSEncoder, MBRSPlainDecoder, SEBottleneck,
                   SENet, SENetDecoder)
from .discriminator import Discriminator
from .fbcnn import QFPredictor
from .localizer import UNetDiscriminator
from .sunet import SUNet
from .unet import UNet, UNetTPU

__all__ = ["DenseSubnet", "InvertibleNet", "RNVPCoupling", "ResSubnet",
           "ResSubnetTPU", "ResSubnetTPUS2", "UNet", "UNetTPU", "ConvBNRelu",
           "HiddenEncoder", "HiddenDecoder", "HiddenDiscriminator",
           "HiddenEncoderDecoder", "SEBottleneck", "SENet", "SENetDecoder",
           "ExpandNet", "MBRSEncoder", "MBRSDecoder", "MBRSPlainDecoder",
           "BalujaPrep", "BalujaHiding", "BalujaReveal", "SUNet",
           "SNConv", "ResnetBlock", "UNetDiscriminator", "Discriminator",
           "QFPredictor"]
