"""The benchmark's plain reference: float32 nets, float64 signal processing,
the cascade, streaming CSS and the uPIT / Adam training step, in plain
PyTorch.  Imports nothing of the measured program."""
