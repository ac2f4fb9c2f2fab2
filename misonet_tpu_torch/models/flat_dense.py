"""The fused U-Net body over the CUDA kernels (misonet_tpu/models/flat_dense.py).

Each fused module subclasses its plain counterpart in ``models.blocks``, so
it owns exactly the same parameters (checkpoints are interchangeable) and
its ``forward`` is the plain path; ``flat`` is the fused path over the
kernels ``ops.kernels.dense_stack`` and ``ops.kernels.stencil``, through
the autograd Functions of ``ops.kernels.flat_grad`` (backward:
``ops.kernels.stencil_bwd``) when autograd records.

Bundle contract (as in the JAX package, without its lane-flattened
framing): ``(tensors, scale, mean)`` where ``tensors`` is a tuple of raw
``[B, c_i, T, F]`` tensors of the working dtype (float32, or bfloat16 for
``compute_dtype="bfloat16"``) whose channel concatenation is logical, and
``scale = 1/sigma``, ``mean`` float32 ``[B, sum(c_i)]`` are their
InstanceNorm statistics, from float32 sums; consumers see ``(x - mean) *
scale``.  A tensor that is already in its final form is bundled with
``scale = 1, mean = 0``.  The kernels run in the bundle's dtype; with
``quant`` (the JAX package's ``quant_int8``, bfloat16 only) the DenseBlocks
run the int8 decode kernel and the stencils stay bfloat16.
"""

from __future__ import annotations

import torch

from misonet_tpu_torch.models.blocks import (
    ConvBlock,
    ConvTranspose2dTorch,
    DeconvBlock,
    DenseBlock,
)
from misonet_tpu_torch.ops.kernels.flat_grad import (
    dense_stack_ad,
    dense_stack_int8_ad,
    stencil_ad,
)
from misonet_tpu_torch.ops.stats import stats_to_scale_mean

Bundle = tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]

# The fused path covers encoder levels 0-4 and their decoder mirrors
# (levels nb-5 .. nb-1); the decoder DenseBlocks start at level 2, so the
# two agree only from 7 levels on.
MIN_LEVELS = 7


def identity_bundle(x: torch.Tensor) -> Bundle:
    """A tensor in its final form, in its own dtype, as a bundle."""
    b, c = x.shape[:2]
    ones = torch.ones((b, c), device=x.device, dtype=torch.float32)
    return (x,), ones, torch.zeros_like(ones)


def stats_bundle(y: torch.Tensor, sums, sqs) -> Bundle:
    scale, mean = stats_to_scale_mean(sums, sqs, y.shape[2] * y.shape[3])
    return (y,), scale, mean


def merge_bundles(*bundles: Bundle) -> Bundle:
    """Logical channel concat of bundles (no data movement)."""
    tensors = sum((tuple(b[0]) for b in bundles), ())
    scale = torch.cat([b[1] for b in bundles], dim=1)
    mean = torch.cat([b[2] for b in bundles], dim=1)
    return tensors, scale, mean


def from_bundle(bundle: Bundle) -> torch.Tensor:
    """Materialize the normalized tensor of a single-tensor bundle,
    normalized in float32 and returned in the bundle's dtype."""
    (x,), scale, mean = bundle
    xn = (x.float() - mean[:, :, None, None]) * scale[:, :, None, None]
    return xn.to(x.dtype)


def resolve_flat(setting, x: torch.Tensor, *, nb: int) -> bool:
    """Resolve ``ModelConfig.flat_dense`` for an input tensor.

    False -> plain path.  "auto" -> fused path iff ``x`` is on CUDA and the
    plan has at least ``MIN_LEVELS`` levels.  True -> fused path, raising
    for a CPU tensor or an unsupported plan.  The CUDA kernels take any
    channel count and frequency size, so the TPU kernels' power-of-two
    framing and 128-channel limits do not apply."""
    if setting is False:
        return False
    if setting == "auto":
        return x.is_cuda and nb >= MIN_LEVELS
    if setting is True:
        if not x.is_cuda:
            raise ValueError(
                "flat_dense=True needs a CUDA input: the fused path runs "
                f"the CUDA kernels (input is on {x.device})"
            )
        if nb < MIN_LEVELS:
            raise ValueError(
                f"flat_dense=True needs at least {MIN_LEVELS} U-Net levels, "
                f"got {nb}"
            )
        return True
    raise ValueError(
        f"flat_dense must be True, False or 'auto', got {setting!r}"
    )


class DenseBlockFlat(DenseBlock):
    """DenseBlock as 5 stacked ``dense_stack`` calls, one per source tensor:
    call s convolves source s with the stacked kernels of layers s..4,
    finalizes layer s and passes the partial pre-activations of layers
    s+1..4 on (misonet_tpu/ops/pallas/dense_stack.py::dense_block_stacked).
    Layer s+1 needs layer s's global statistics, so the partials leave the
    kernel between calls."""

    def _stack(self) -> list[torch.Tensor]:
        stacks = []
        for s in range(len(self.convs)):
            # channel range of source s in the layers' inputs
            off = 0 if s == 0 else self.in_ch + (s - 1) * self.g1
            cw = self.in_ch if s == 0 else self.g1
            stacks.append(torch.cat(
                [c.weight[:, off : off + cw] for c in self.convs[s:]], dim=0,
            ))
        return stacks

    def stacked_weights(self, dtype=torch.float32) -> list[torch.Tensor]:
        """The ``w_stack`` of each call s in ``dtype``: the kernels of
        layers s..4 over source s's input channels, ``[sum(widths[s:]), c_s,
        3, 3]``.

        When autograd records a weight, the float32 stacks are built inside
        the graph on every call, whatever ``dtype`` (the ``cat`` splits
        ``dW_stack`` back into the layers' gradients; the kernels' autograd
        Functions cast them to the sources' dtype, so the gradients stay
        float32; the optimizer's in-place step changes the weights each
        step anyway).  Otherwise they are built once per dtype and rebuilt
        only when a weight is replaced, gets new storage or an in-place
        update.  Weights made under ``torch.inference_mode`` keep no
        version counter, so for them the stacks are rebuilt on every
        call."""
        weights = [c.weight for c in self.convs]
        if torch.is_grad_enabled() and any(w.requires_grad for w in weights):
            return self._stack()
        key = (None if any(w.is_inference() for w in weights) else
               tuple((id(w), w.data_ptr(), w._version) for w in weights))
        cache = self.__dict__.setdefault("_stacks", {})
        if key is None or cache.get(dtype, (None,))[0] != key:
            with torch.no_grad():
                cache[dtype] = (key, [w.to(dtype) for w in self._stack()])
            # keeps the keyed weights alive, so no other tensor can take
            # their ids or storage while the key stands
            self._stacked_from = weights
        return cache[dtype][1]

    def flat(self, bundle: Bundle, quant: bool = False) -> Bundle:
        """Bundle in -> the 5th layer's raw output with its statistics.
        ``quant``: the int8 decode kernel on a bfloat16 bundle (its rows are
        quantized from the float32 stacks)."""
        src, scale, mean = bundle
        call = dense_stack_int8_ad if quant else dense_stack_ad
        stacks = self.stacked_weights(torch.float32 if quant
                                      else src[0].dtype)
        acc = None
        for s, (conv, w_stack) in enumerate(zip(self.convs, stacks)):
            y, sums, sqs, acc = call(
                src, acc, w_stack, conv.bias, scale, mean,
                n_fin=self.widths[s],
            )
            (y,), scale, mean = stats_bundle(y, sums, sqs)
            src = (y,)
        return src, scale, mean


class Enc0Flat(ConvBlock):
    """Encoder level 0's bare trunk conv (stride 1, F -> F-2) straight from
    the complex-stacked input; its output is consumed as-is (identity
    statistics), like the reference feeds it to the DenseBlock."""

    def flat(self, x: torch.Tensor) -> Bundle:
        y, _, _ = stencil_ad(x, self.conv.weight, self.conv.bias, None, None,
                             "enc0")
        return identity_bundle(y)


class TrunkDownFlat(ConvBlock):
    """Encoder trunk conv (stride (1,2), freq VALID) + ELU with the input
    normalized on load; returns the raw output with its statistics."""

    def flat(self, bundle: Bundle) -> Bundle:
        (x,), scale, mean = bundle
        y, sums, sqs = stencil_ad(x, self.conv.weight, self.conv.bias, scale,
                                  mean, "down")
        return stats_bundle(y, sums, sqs)


class DeconvUpFlat(DeconvBlock):
    """Decoder transpose conv (stride (1,2), F -> 2F+1) + ELU with the input
    normalized on load; returns the raw output with its statistics."""

    def flat(self, bundle: Bundle) -> Bundle:
        (x,), scale, mean = bundle
        y, sums, sqs = stencil_ad(x, self.deconv.weight, self.deconv.bias,
                                  scale, mean, "up")
        return stats_bundle(y, sums, sqs)


class FinalDeconvFlat(ConvTranspose2dTorch):
    """The decoder's final bare transpose conv (stride 1, F -> F+2, all
    bins) with the input normalized on load."""

    def flat(self, bundle: Bundle) -> torch.Tensor:
        (x,), scale, mean = bundle
        y, _, _ = stencil_ad(x, self.weight, self.bias, scale, mean, "final")
        return y
