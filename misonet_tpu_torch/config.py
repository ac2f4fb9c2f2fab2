"""The configuration dataclasses the port uses (misonet_tpu/config.py).

``misonet_tpu.config`` is framework-free dataclasses, so the port shares
them rather than copying them: a config built for the JAX package drives
the port unchanged.  This module is the port's only contact with the JAX
package; everything else in ``misonet_tpu_torch`` (and ``chip_smoke.py``)
imports the configs from here.
"""

from misonet_tpu.config import DatasetConfig, ModelConfig, StftConfig

__all__ = ["DatasetConfig", "ModelConfig", "StftConfig"]
