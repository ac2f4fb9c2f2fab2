"""Utilities of the port (misonet_tpu/utils)."""
