"""MVDR beamforming and streaming SCMs of the port (misonet_tpu/beamforming)."""

from misonet_tpu_torch.beamforming.mvdr import (
    mvdr_beamform,
    mvdr_weights,
    phase_correct,
    principal_eigenvector,
    spatial_covariance,
    steering_weights,
)
from misonet_tpu_torch.beamforming.scm import (
    chunked_scm,
    streaming_scm_update,
)
