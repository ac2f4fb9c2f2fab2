"""Exercise every collective of the port on a mesh of n ranks
(``__graft_entry__.py::dryrun_multichip`` of the JAX package).

Every rank of an initialized process group (``parallel.distributed.
initialize``; NCCL for the cards, gloo for the CPU) calls
``dryrun_multichip(n, device=...)``.  Tiny shapes, the real layouts:

  1. the data-parallel MISO1 separation train step (forward, uPIT, the
     gradient all_reduce, Adam), parameters identical on every rank after it
  2. the data-parallel MISO3 enhancement train step
  3. ``chunked_scm`` over the mesh (the collective SCM accumulation)
  4. the sequence-parallel TCN through a full small MISO1 (halo exchange,
     collective IN / gLN statistics) against the local model
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from misonet_tpu_torch.beamforming.scm import chunked_scm
from misonet_tpu_torch.config import ModelConfig, OptimizerConfig
from misonet_tpu_torch.models import make_miso1, make_miso3
from misonet_tpu_torch.parallel import make_mesh, replicate, shard_batch
from misonet_tpu_torch.train import (
    create_train_state,
    make_enhance_train_step,
    make_optimizer,
    make_separate_train_step,
)

# the JAX dryrun's small sequence-parallel plan (4 levels, F = 17)
SP_PLAN = dict(num_bottleneck=4, en_channels=(8, 8, 8, 16),
               de_channels=(16, 8, 8, 8), tcn_repeats=1, tcn_blocks=3,
               tcn_channels=16, compute_dtype="float32")


def _cx(rng, shape, device):
    v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(v.astype(np.complex64)).to(device)


def _same_on_every_rank(model, mesh) -> float:
    """Largest distance of this rank's parameters to the first rank's."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    first = flat.clone()
    dist.broadcast(first, mesh.ranks[0], group=mesh.group)
    return (flat - first).abs().max().item()


def _train_step(model, make_step, mesh, inputs):
    optimizer = make_optimizer(OptimizerConfig(), model.parameters())
    state = create_train_state(model, optimizer)
    step = make_step(model, optimizer, mesh=mesh)
    replicate(model, mesh)
    state, metrics = step(state, *shard_batch(inputs, mesh))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"loss {loss}")
    spread = _same_on_every_rank(model, mesh)
    if spread != 0.0:
        raise AssertionError(f"parameters differ across ranks by {spread}")
    return loss


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """Run the four checks over the first ``n_devices`` ranks (every rank
    of the group calls it); returns the MISO1 step's loss.  Raises on a
    failed check."""
    mesh = make_mesh(n_devices)
    if mesh.size != n_devices:
        raise AssertionError((mesh.size, n_devices))
    rng = np.random.default_rng(0)
    b, c, t, f = n_devices, 6, 8, 129   # tiny time axis, real freq ladder
    cfg = ModelConfig(compute_dtype="float32")

    # -- 1. DP MISO1 separate train step
    model = make_miso1(cfg, c, device=device)
    mix, ref = _cx(rng, (b, c, t, f), device), _cx(rng, (b, 2, t, f), device)
    loss = _train_step(model, make_separate_train_step, mesh, (mix, ref))
    print(f"  [1/4] DP separate train step: ok, loss={loss:.4f}")

    # -- 2. DP MISO3 enhance train step
    m3 = make_miso3(cfg, c, device=device)
    x, y = _cx(rng, (b, c + 2, t, f), device), _cx(rng, (b, 1, t, f), device)
    loss3 = _train_step(m3, make_enhance_train_step, mesh, (x, y))
    print(f"  [2/4] DP enhance train step: ok, loss={loss3:.4f}")

    # -- 3. collective SCM accumulation over the mesh
    blocks = _cx(rng, (n_devices, c, t, f), device)
    full = chunked_scm(blocks).cpu().numpy()
    sharded = chunked_scm(shard_batch(blocks, mesh), mesh).cpu().numpy()
    np.testing.assert_allclose(sharded, full, atol=1e-3)
    print("  [3/4] chunked_scm all_reduce over the mesh: ok")

    # -- 4. sequence-parallel TCN through the full model
    seq_mesh = make_mesh(n_devices, axis="seq")
    local = make_miso1(ModelConfig(**SP_PLAN), 3, device=device)
    sp = make_miso1(ModelConfig(**SP_PLAN, sequence_parallel=True), 3,
                    device=device, sp_mesh=seq_mesh)
    sp.load_state_dict(local.state_dict())
    t_sp = max(8 * n_devices, 32)   # >= the dilation halo per shard
    mix_sp = _cx(rng, (1, 3, t_sp, 17), device)
    with torch.no_grad():
        out_local = local(mix_sp).cpu().numpy()
        out_sp = sp(mix_sp).cpu().numpy()
    np.testing.assert_allclose(out_sp, out_local, atol=2e-4, rtol=2e-4)
    print("  [4/4] sequence-parallel TCN (halo + collective stats): ok")

    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.4f}")
    return loss

