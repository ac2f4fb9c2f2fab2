"""The port's networks: the MISO U-Net + TCN (misonet_tpu/models) and
TF-GridNet, which ``make_miso1`` builds for a ``TFGridNetConfig``."""

from misonet_tpu_torch.models.miso import (
    MISONet,
    enhance_input,
    make_miso1,
    make_miso2,
    make_miso3,
)
from misonet_tpu_torch.models.tfgridnet import TFGridNet
