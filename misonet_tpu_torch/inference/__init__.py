"""Inference of the port (misonet_tpu/inference): decode, cascade,
evaluator, streaming CSS."""
