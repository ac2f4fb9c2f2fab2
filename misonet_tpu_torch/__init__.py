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
  * ``data``                       extraction, shards and batches, wav I/O,
                                   synthetic corpora, precomputed features
  * ``losses`` / ``train``         uPIT and enhancement losses; optimizer,
                                   train state, the train/eval steps and
                                   the trainers
  * ``utils``                      checkpoints, metric writer, profiling;
                                   JAX params -> port ``state_dict``
  * ``config``                     the configuration and its YAML reader (a
                                   copy of the JAX package's)
  * ``cli`` (``python -m misonet_tpu_torch``)  run.py's modes and flags

Tensors are NCHW ``[B, C, T, F]``; the networks compute in float32 or, as
the JAX package by default, bfloat16 (``ModelConfig.compute_dtype``), with
float32 parameters.  The port imports ``torch`` and nothing of the JAX
package.
"""

__version__ = "0.1.0"
