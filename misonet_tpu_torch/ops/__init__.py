"""Signal ops and kernels of the port (see misonet_tpu/ops for the JAX side)."""
