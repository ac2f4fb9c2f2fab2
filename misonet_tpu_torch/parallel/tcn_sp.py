"""Sequence-parallel TCN: the time axis sharded over a mesh with halo
exchange (misonet_tpu/parallel/tcn_sp.py).

For long-form input the TCN bottleneck can run with its time axis split
over the ranks of a :class:`~misonet_tpu_torch.parallel.mesh.Mesh`.
:class:`TemporalConvNetSP` has the parameters and ``state_dict`` of
``models.blocks.TemporalConvNet`` and computes the same function, in
float32 as the JAX module does:

* every dilated depthwise conv exchanges ``dilation`` frames of halo with
  each neighbour (``dist.batch_isend_irecv``; the edge shards pad with
  zeros, the conv's own padding);
* every normalization (outer IN, inner gLN) takes exact global statistics
  from an ``all_reduce`` of the local (sum, sum of squares) and the global
  frame count;
* pointwise convs, PReLU and residuals are local.

Each rank enters with the whole input (the layers before the TCN run on
every rank) and leaves with the whole output.  It is differentiable, as
JAX's ``shard_map`` body is; the collectives come with their adjoints:

* the statistics' ``all_reduce`` sums the cotangents over the ranks in
  its backward (what ``torch.distributed.nn.functional.all_reduce`` does,
  which torch 2.13 deprecates);
* the halo exchange's backward returns the halo cotangents to their owners;
* taking this rank's block of the input gathers the input's cotangent in
  the backward, and gathering the output takes this rank's block of its
  cotangent (the layers after the TCN are replicated, so every rank holds
  the same output cotangent);
* the parameters are replicated, so their cotangents, each rank's share
  from its block, are summed over the ranks.

Every rank then ends the backward with the same, whole gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from misonet_tpu_torch.models.blocks import EPS_GLN, EPS_IN, TemporalConvNet
from misonet_tpu_torch.parallel.mesh import Mesh


def _gather_time(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=-1)


def _block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = x.shape[-1] // mesh.size
    return x[..., mesh.index * n:(mesh.index + 1) * n].contiguous()


class _Shard(torch.autograd.Function):
    """Replicated [..., T] -> this rank's block [..., T / size]."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _block(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_time(g, ctx.mesh), None


class _Gather(torch.autograd.Function):
    """This rank's block [..., T / size] -> replicated [..., T]."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_time(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh), None


class _Sum(torch.autograd.Function):
    """The sum over the ranks, whose backward sums the cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.clone()
        dist.all_reduce(x, group=mesh.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.mesh), None


class _Replicated(torch.autograd.Function):
    """A replicated parameter at its use: the identity, whose backward sums
    the ranks' cotangents."""

    @staticmethod
    def forward(ctx, p, mesh):
        ctx.mesh = mesh
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


def _swap_edges(left, right, mesh: Mesh):
    """Send ``left`` to the previous rank and ``right`` to the next one;
    return (what the previous rank sent, what the next one sent), zeros at
    the ends of the axis."""
    k, ranks = mesh.index, mesh.ranks
    from_prev, from_next = torch.zeros_like(right), torch.zeros_like(left)
    ops = []
    if k > 0:
        ops += [dist.P2POp(dist.isend, left, ranks[k - 1], mesh.group),
                dist.P2POp(dist.irecv, from_prev, ranks[k - 1], mesh.group)]
    if k < mesh.size - 1:
        ops += [dist.P2POp(dist.isend, right, ranks[k + 1], mesh.group),
                dist.P2POp(dist.irecv, from_next, ranks[k + 1], mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    """[..., T_loc] -> [..., T_loc + 2 * halo]: the previous rank's last
    ``halo`` frames, the block, the next rank's first ``halo`` frames."""

    @staticmethod
    def forward(ctx, x, halo, mesh):
        ctx.halo, ctx.mesh = halo, mesh
        left = x[..., :halo].contiguous()
        right = x[..., -halo:].contiguous()
        from_prev, from_next = _swap_edges(left, right, mesh)
        return torch.cat([from_prev, x, from_next], dim=-1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        # the cotangents of the received halos go back to their owners
        to_prev = g[..., :h].contiguous()
        to_next = g[..., -h:].contiguous()
        from_prev, from_next = _swap_edges(to_prev, to_next, ctx.mesh)
        dx = g[..., h:-h].clone()
        dx[..., :h] += from_prev
        dx[..., -h:] += from_next
        return dx, None, None


def _global_stats(s, ss, count, mesh: Mesh):
    """(mean, variance) from local sums ``s``, ``ss`` and the global
    element count."""
    tot = _Sum.apply(torch.stack([s, ss]), mesh)
    mean = tot[0] / count
    return mean, tot[1] / count - mean * mean


def _instance_norm(x, mesh: Mesh):
    """IN over the whole time axis per (batch, channel); x [B, C, T_loc]."""
    mean, var = _global_stats(x.sum(2, keepdim=True),
                              (x * x).sum(2, keepdim=True),
                              x.shape[2] * mesh.size, mesh)
    return (x - mean) * torch.rsqrt(var + EPS_IN)


def _gln(x, gamma, beta, mesh: Mesh):
    """gLN over (channel, time) per batch element; gamma, beta [1, 1, C]."""
    mean, var = _global_stats(x.sum((1, 2), keepdim=True),
                              (x * x).sum((1, 2), keepdim=True),
                              x.shape[1] * x.shape[2] * mesh.size, mesh)
    return (gamma.reshape(1, -1, 1) * (x - mean) / torch.sqrt(var + EPS_GLN)
            + beta.reshape(1, -1, 1))


class TemporalConvNetSP(TemporalConvNet):
    """``TemporalConvNet`` with its time axis sharded over ``mesh``: the
    same parameters (and ``state_dict``), the same output.  Raises unless
    the outer norm is "IN" (as JAX's), the frame count divides by the mesh
    size, and each dilation's halo lies within one neighbour's block."""

    def __init__(self, repeats: int, blocks: int, features: int,
                 norm_type: str, mesh: Mesh):
        if norm_type != "IN":
            raise ValueError("the sequence-parallel TCN implements the IN "
                             f"outer norm, not {norm_type!r}")
        super().__init__(repeats, blocks, features, norm_type)
        self.mesh = mesh
        self.max_dilation = 2 ** (blocks - 1)

    def _p(self, p):
        return _Replicated.apply(p, self.mesh)

    def _dsconv(self, x, m):
        d = m.depthwise.dilation[0]
        y = F.conv1d(_Halo.apply(x, d, self.mesh), self._p(m.depthwise.weight),
                     dilation=d, groups=x.shape[1])
        y = torch.where(y >= 0, y, self._p(m.prelu.alpha) * y)
        y = _gln(y, self._p(m.norm.gamma), self._p(m.norm.beta), self.mesh)
        return F.conv1d(y, self._p(m.pointwise.weight))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, n = x.shape[-1], self.mesh.size
        if t % n:
            raise ValueError(f"sequence-parallel TCN: T={t} frames do not "
                             f"divide over {n} ranks")
        if self.max_dilation > t // n:
            raise ValueError(
                f"sequence-parallel TCN: a halo of {self.max_dilation} frames "
                f"spans more than one neighbour's {t // n}-frame block")
        h = _Shard.apply(x.float(), self.mesh)
        for block in self.children():
            y = _instance_norm(h, self.mesh)
            y = self._dsconv(F.elu(y), block.dsconv1)
            y = _instance_norm(y, self.mesh)
            h = self._dsconv(F.elu(y), block.dsconv2) + h
        return _Gather.apply(h, self.mesh).to(x.dtype)
