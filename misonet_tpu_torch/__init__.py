"""misonet_tpu_torch — the PyTorch + CUDA port of misonet_tpu for NVIDIA Hopper.

The JAX package ``misonet_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find:

  * ``ops.stft`` / ``ops.chunk``   framed-FFT STFT/iSTFT, utterance chunking
  * ``ops.kernels``                hand-written CUDA kernels (``csrc/``) for
                                   the fused U-Net body, each beside its
                                   plain PyTorch version
  * ``models``                     the MISO U-Net + TCN (``MISONet``)
  * ``inference``                  circular-shift decode and the MISO1
                                   separation evaluator
  * ``utils.weights``              JAX params -> port ``state_dict``
  * ``config``                     the shared configuration dataclasses

Everything computes in float32 on NCHW ``[B, C, T, F]`` tensors.  The port
imports ``torch`` and, of the JAX package, only the framework-free
``misonet_tpu.config`` dataclasses, through ``config``.
"""

__version__ = "0.1.0"
