"""The weight layouts of the tensor-core kernels.

``csrc/conv_mma.cuh`` reduces a 3x3 conv over units of one 16-byte group
of channels at one tap: 4 float32, 8 bf16 or 16 int8 channels.  Its
weights come packed so that a block reads each (unit, output channel) as
one 16-byte copy.

float32 and bf16 (:func:`pack_tc_weights`): ``[G, 9, O, group]`` (group
4 for float32, 8 for bf16), element ``[g, tap, o, e]`` the weight of
output channel ``o`` and reduced channel ``group * g + e`` of the padded
reduction axis at ``tap = 3 kt + kf``.  The reduced channels of each
source are padded with zeros to a multiple of the group (a unit never
spans two sources).  ``dense_stack`` and ``dense_layer`` pack their ``[N,
C, 3, 3]`` weight as it is (output n, reduced c), ``stencil`` its conv
weights as they are and its transpose weights ``[C, N, 3, 3]`` transposed
(output n, reduced c); ``stencil_bwd``'s dgrad packs the transpose (output
c, reduced n).

int8 (:func:`pack_int8_rows`): the quantized weight rows of one
``dense_stack_int8`` call, ``[B, G16, 9, N, 16]``, one set per batch
element (the rows depend on its statistics), each source's channels
zero-padded to a multiple of 16.  The card builds this layout directly in
``quantize_rows_kernel`` (csrc/dense_stack_int8.cu); the function here is
its plain twin.

The float32 kernels multiply in three TF32 passes over split operands:
:func:`tf32_split` is the plain twin of their split (``tc::split_tf32``):
``big = tf32(x)``, ``small = tf32(x - big)``, each rounded to TF32's 10
explicit mantissa bits, ties away from zero (``cvt.rna.tf32.f32``); the
kernels multiply ``big big + big small + small big``, and only ``small
small``, about 2^-22 of a product, is left out.  Their weights come split
once, here: ``packed`` of a float32 weight is ``[2, G, 9, O, 4]``, the
groups of 4 of the big plane, then of the small one, made on the card by
one launch of ``pack_tf32_kernel`` (``csrc/tc_pack.cu``, wrapper
:func:`pack_tf32`, plain twin :func:`pack_tf32_plain`).

Packing a bf16 weight is a few PyTorch ops; ``packed`` caches the result
per weight tensor, version and dtype (a weakref drops the entry with the
tensor), so a serving model packs its cached weight stacks and its
stencil weights once and a train step packs each fresh weight or bf16
cast once per role.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F

from misonet_tpu_torch.ops.kernels import build

MAX_SOURCES = 8  # sources of one pack_tf32 call (csrc/tc_pack.cu)


def pack_tc_weights(w: torch.Tensor, widths, group: int = 8) -> torch.Tensor:
    """``w`` [O, R, 3, 3] (output, reduced) with its reduced axis the
    concatenation of sources of ``widths`` -> ``[G, 9, O, group]``, G = sum
    of ceil(width / group), each source's channels zero-padded to a
    multiple of ``group`` (4 for the float32 kernels, 8 for bf16)."""
    o = w.shape[0]
    parts, off = [], 0
    for c in widths:
        blk = w[:, off:off + c]
        off += c
        if c % group:
            blk = F.pad(blk, (0, 0, 0, 0, 0, group - c % group))
        parts.append(blk)
    if off != w.shape[1]:
        raise ValueError(f"pack_tc_weights: widths {tuple(widths)} do not "
                         f"sum to the {w.shape[1]} reduced channels")
    wp = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return wp.reshape(o, -1, group, 9).permute(1, 3, 0, 2).contiguous()


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits, the low 13
    bits zero), to nearest with ties away from zero: ``cvt.rna.tf32.f32``.
    Adding half of the dropped field to the sign-magnitude bit pattern
    rounds the magnitude half up, whatever the sign."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round: float32 only, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) = (tf32(x), tf32(x - big)) of float32 ``x``: the split
    the float32 kernels make of each operand (x - big is exact in
    float32)."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def pack_tf32_plain(w: torch.Tensor, widths,
                    transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack_tf32`: the :func:`tf32_split`
    of :func:`pack_tc_weights` at group 4, as ``[2, G, 9, O, 4]``."""
    src = w.transpose(0, 1) if transpose else w
    return torch.stack(tf32_split(pack_tc_weights(src, widths, 4)))


def pack_tf32(w: torch.Tensor, widths, transpose: bool = False) -> torch.Tensor:
    """The float32 kernels' weight planes of ``w`` [O, R, 3, 3] (of
    ``w.transpose(0, 1)`` with ``transpose``, ``w`` then [R, O, 3, 3]):
    ``[2, G, 9, O, 4]``, the big and small TF32 parts of the groups of 4,
    each of the 1-8 sources of ``widths`` zero-padded to a multiple of 4.
    One launch of ``pack_tf32_kernel`` for a CUDA tensor,
    :func:`pack_tf32_plain` for a CPU one."""
    widths = [int(c) for c in widths]
    device = w.device
    if device.type == "cpu":
        return pack_tf32_plain(w, widths, transpose)
    if device.type != "cuda":
        raise ValueError(f"pack_tf32: unsupported device {device}")
    if w.dtype != torch.float32 or w.dim() != 4 or w.shape[2:] != (3, 3):
        raise ValueError(f"pack_tf32: w must be float32 [., ., 3, 3], got "
                         f"{w.dtype} {tuple(w.shape)}")
    o, r = (w.shape[1], w.shape[0]) if transpose else w.shape[:2]
    if not 1 <= len(widths) <= MAX_SOURCES or min(widths) < 1:
        raise ValueError(f"pack_tf32 takes 1-{MAX_SOURCES} positive source "
                         f"widths, got {widths}")
    if sum(widths) != r:
        raise ValueError(f"pack_tf32: widths {tuple(widths)} do not sum to "
                         f"the {r} reduced channels")
    w = w.contiguous()
    groups = sum(-(-c // 4) for c in widths)
    out = torch.empty((2, groups, 9, o, 4), device=device)
    with torch.cuda.device(device):
        err = library().misonet_pack_tf32(
            w.data_ptr(), o, r, int(transpose),
            (ctypes.c_int * len(widths))(*widths), len(widths),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pack_tf32_kernel launch failed: CUDA error {err}")
    build.count_launch(pack_tf32, "launches")
    return out


# launches of the pack kernel (part of the float32 dense_stack, dense_layer,
# stencil and stencil_bwd calls that pack a new weight version, so not one
# of launch_counts()'s kernel modes)
pack_tf32.launches = 0


def library() -> ctypes.CDLL:
    lib = build.library()
    lib.misonet_pack_tf32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.misonet_pack_tf32.restype = ctypes.c_int
    return lib


# (id(w), widths, transpose, dtype) -> (weakref to w, w's version, packed)
_CACHE: dict = {}


def _forget(wid):
    for key in [k for k in _CACHE if k[0] == wid]:
        _CACHE.pop(key, None)


def packed(w: torch.Tensor, widths, transpose: bool = False,
           dtype=None) -> torch.Tensor:
    """:func:`pack_tc_weights` of ``w`` (of ``w.transpose(0, 1)`` with
    ``transpose``; cast to ``dtype`` if given), in the layout of its
    dtype's kernels: float32, the two planes ``[2, G, 9, O, 4]`` of
    :func:`pack_tf32`; any other dtype, groups of 8.
    Cached per tensor, version and dtype.  Tensors made under
    ``torch.inference_mode`` keep no version counter: packed on every
    call."""
    def pack():
        src = w if dtype is None else w.to(dtype)
        if src.dtype == torch.float32:
            return pack_tf32(src, widths, transpose)
        return pack_tc_weights(src.transpose(0, 1) if transpose else src,
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
