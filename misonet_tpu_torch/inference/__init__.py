"""MISO1 inference of the port (misonet_tpu/inference)."""
