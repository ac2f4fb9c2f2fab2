"""Host-side data helpers of the port (misonet_tpu/data)."""
