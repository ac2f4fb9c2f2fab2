"""The weight layout of the bfloat16 tensor-core kernels.

``csrc/conv_mma.cuh`` reduces a 3x3 conv over units of 8 channels at one
tap.  Its weights come packed so that a block reads each (unit, output
channel) as one 16-byte copy: ``[G, 9, O, 8]`` bf16, element ``[g, tap, o,
e]`` the weight of output channel ``o`` and reduced channel ``8 g + e`` of
the padded reduction axis at ``tap = 3 kt + kf``.  The reduced channels of
each source are padded with zeros to a multiple of 8 (a unit never spans
two sources).  ``dense_stack`` and ``dense_layer`` pack their ``[N, C, 3,
3]`` weight as it is (output n, reduced c); ``stencil_bwd``'s dgrad packs
the transpose (output c, reduced n).

Packing is a few PyTorch ops; ``packed`` caches the result per weight
tensor and version (a weakref drops the entry with the tensor), so a
serving model packs its cached weight stacks once and a train step packs
each fresh bf16 cast once per role.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F


def pack_tc_weights(w: torch.Tensor, widths) -> torch.Tensor:
    """``w`` [O, R, 3, 3] (output, reduced) with its reduced axis the
    concatenation of sources of ``widths`` -> ``[G, 9, O, 8]``, G = sum of
    ceil(width / 8), each source's channels zero-padded to a multiple of 8."""
    o = w.shape[0]
    parts, off = [], 0
    for c in widths:
        blk = w[:, off:off + c]
        off += c
        if c % 8:
            blk = F.pad(blk, (0, 0, 0, 0, 0, 8 - c % 8))
        parts.append(blk)
    if off != w.shape[1]:
        raise ValueError(f"pack_tc_weights: widths {tuple(widths)} do not "
                         f"sum to the {w.shape[1]} reduced channels")
    wp = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return wp.reshape(o, -1, 8, 9).permute(1, 3, 0, 2).contiguous()


# (id(w), widths, transpose) -> (weakref to w, w's version, packed)
_CACHE: dict = {}


def _forget(wid):
    for key in [k for k in _CACHE if k[0] == wid]:
        _CACHE.pop(key, None)


def packed(w: torch.Tensor, widths, transpose: bool = False) -> torch.Tensor:
    """:func:`pack_tc_weights` of ``w`` (of ``w.transpose(0, 1)`` with
    ``transpose``), cached per tensor and version.  Tensors made under
    ``torch.inference_mode`` keep no version counter: packed on every
    call."""
    src = w.transpose(0, 1) if transpose else w
    if w.is_inference():
        return pack_tc_weights(src, widths)
    key = (id(w), tuple(widths), transpose)
    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    out = pack_tc_weights(src, widths)
    # the entries of a tensor go when it does, before its id can return
    ref = weakref.ref(w, lambda _, wid=id(w): _forget(wid))
    _CACHE[key] = (ref, w._version, out)
    return out
