"""MISO networks of the port (misonet_tpu/models)."""

from misonet_tpu_torch.models.miso import (
    MISONet,
    enhance_input,
    make_miso1,
    make_miso2,
    make_miso3,
)
