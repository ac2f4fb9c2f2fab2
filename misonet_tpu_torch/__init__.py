"""misonet_tpu_torch — the PyTorch + CUDA port of misonet_tpu for NVIDIA Hopper.

The JAX package ``misonet_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find:

  * ``ops.stft`` / ``ops.chunk``   framed-FFT STFT/iSTFT, utterance chunking
  * ``ops.kernels``                hand-written CUDA kernels (``csrc/``) for
                                   the fused U-Net body, forward and
                                   backward, and the MVDR's batched
                                   Hermitian solve, each beside its plain
                                   PyTorch version; ``flat_grad`` makes the
                                   U-Net kernels differentiable
  * ``models``                     the MISO U-Net + TCN (``MISONet``)
  * ``beamforming``                MVDR and streaming SCMs
  * ``inference``                  circular-shift decode, the MISO1 -> MVDR
                                   -> MISO3/MISO2 cascade and its evaluator,
                                   streaming CSS
  * ``data.wavio``                 wav reading and writing
  * ``losses`` / ``train``         uPIT and enhancement losses; optimizer,
                                   train state and the train/eval steps
  * ``utils.weights``              JAX params -> port ``state_dict``
  * ``config``                     the configuration dataclasses (a copy of
                                   the JAX package's)

Everything computes in float32 on NCHW ``[B, C, T, F]`` tensors.  The port
imports ``torch`` and nothing of the JAX package.
"""

__version__ = "0.1.0"
