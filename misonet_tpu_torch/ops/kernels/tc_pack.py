"""The weight layouts of the tensor-core kernels.

``csrc/conv_mma.cuh`` reduces a 3x3 conv over units of one 16-byte group
of channels at one tap: 8 bf16 channels, or 16 int8 channels.  Its
weights come packed so that a block reads each (unit, output channel) as
one 16-byte copy.

bf16 (:func:`pack_tc_weights`): ``[G, 9, O, 8]``, element ``[g, tap, o,
e]`` the weight of output channel ``o`` and reduced channel ``8 g + e`` of
the padded reduction axis at ``tap = 3 kt + kf``.  The reduced channels of
each source are padded with zeros to a multiple of 8 (a unit never spans
two sources).  ``dense_stack`` and ``dense_layer`` pack their ``[N, C, 3,
3]`` weight as it is (output n, reduced c), ``stencil`` its conv weights as
they are and its transpose weights ``[C, N, 3, 3]`` transposed (output n,
reduced c); ``stencil_bwd``'s dgrad packs the transpose (output c, reduced
n).

int8 (:func:`pack_int8_rows`): the quantized weight rows of one
``dense_stack_int8`` call, ``[B, G16, 9, N, 16]``, one set per batch
element (the rows depend on its statistics), each source's channels
zero-padded to a multiple of 16.  The card builds this layout directly in
``quantize_rows_kernel`` (csrc/dense_stack_int8.cu); the function here is
its plain twin.

Packing is a few PyTorch ops; ``packed`` caches the bf16 result per weight
tensor, version and dtype (a weakref drops the entry with the tensor), so
a serving model packs its cached weight stacks and its float32 stencil
weights once and a train step packs each fresh bf16 cast once per role.
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


def pack_int8_rows(qw: torch.Tensor, widths) -> torch.Tensor:
    """``qw`` int8 [B, N, 9, C] (tap-major, channels fastest; C the
    concatenation of sources of ``widths``) -> ``[B, G16, 9, N, 16]``,
    G16 = sum of ceil(width / 16), each source's channels zero-padded to a
    multiple of 16."""
    b, n, taps, c_tot = qw.shape
    parts, off = [], 0
    for c in widths:
        blk = qw[..., off:off + c]
        off += c
        if c % 16:
            blk = torch.cat([blk, blk.new_zeros((b, n, taps, 16 - c % 16))],
                            dim=-1)
        parts.append(blk)
    if off != c_tot:
        raise ValueError(f"pack_int8_rows: widths {tuple(widths)} do not sum "
                         f"to the {c_tot} reduced channels")
    q = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    return q.reshape(b, n, taps, -1, 16).permute(0, 3, 2, 1, 4).contiguous()


# (id(w), widths, transpose, dtype) -> (weakref to w, w's version, packed)
_CACHE: dict = {}


def _forget(wid):
    for key in [k for k in _CACHE if k[0] == wid]:
        _CACHE.pop(key, None)


def packed(w: torch.Tensor, widths, transpose: bool = False,
           dtype=None) -> torch.Tensor:
    """:func:`pack_tc_weights` of ``w`` (of ``w.transpose(0, 1)`` with
    ``transpose``; cast to ``dtype`` if given), cached per tensor, version
    and dtype.  Tensors made under ``torch.inference_mode`` keep no version
    counter: packed on every call."""
    def pack():
        src = w.transpose(0, 1) if transpose else w
        return pack_tc_weights(src if dtype is None else src.to(dtype),
                               widths)

    if w.is_inference():
        return pack()
    key = (id(w), tuple(widths), transpose, dtype)
    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    out = pack()
    # the entries of a tensor go when it does, before its id can return
    ref = weakref.ref(w, lambda _, wid=id(w): _forget(wid))
    _CACHE[key] = (ref, w._version, out)
    return out
