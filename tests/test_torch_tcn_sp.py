"""PyTorch port, the sequence-parallel TCN (parallel/tcn_sp.py) on two gloo
ranks in spawned processes (spawned once for the file, a ``file://``
rendezvous under ``tmp_path``, a timeout of its own), at
tests/test_tcn_sp.py's sizes and its 2e-5 tolerance (atol and rtol):

* ``TemporalConvNetSP`` against the port's local ``TemporalConvNet`` and
  against JAX's ``tcn_time_sharded`` on the conftest's 8-device CPU mesh,
  from the same parameters (JAX's, through the weight bridge): B = 2, T =
  256, 16 channels, dilations to 8; and the large-dilation case (dilation
  8, T = 128);
* gradients of a fixed projection of the output, with respect to the
  input and every parameter, against the local TCN's (2e-5 of the largest
  gradient; float32, sums in another order), the same on both ranks;
* ``sequence_parallel=True`` through the full small MISO1 of
  tests/test_tcn_sp.py (4 levels, T = 64, F = 17): output within its 2e-4
  against the local model, and the parameter gradients within 2e-5 of the
  largest;
* the constraints it raises on, in this process.
"""

import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from misonet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from misonet_tpu.models.blocks import TemporalConvNet as JaxTCN  # noqa: E402
from misonet_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from misonet_tpu.parallel.tcn_sp import tcn_time_sharded  # noqa: E402
from misonet_tpu_torch.config import ModelConfig  # noqa: E402
from misonet_tpu_torch.dryrun import SP_PLAN  # noqa: E402
from misonet_tpu_torch.models import make_miso1  # noqa: E402
from misonet_tpu_torch.models.blocks import TemporalConvNet  # noqa: E402
from misonet_tpu_torch.parallel import Mesh  # noqa: E402
from misonet_tpu_torch.parallel.tcn_sp import TemporalConvNetSP  # noqa: E402
from misonet_tpu_torch.utils.weights import jax_to_state_dict  # noqa: E402

WORLD = 2
SPAWN_TIMEOUT = 120
TOL = 2e-5
MODEL_TOL = 2e-4
# (name, repeats, blocks, channels, B, T) of tests/test_tcn_sp.py
CASES = [("dense", 2, 4, 16, 2, 256), ("large_dilation", 1, 4, 8, 1, 128)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcn_case(name, repeats, blocks, ch, b, t):
    """JAX parameters (seeded through init), the input [B, T, C] and JAX's
    8-device sharded output, with the port's state_dict of the TCN."""
    model = JaxTCN(repeats=repeats, blocks=blocks, features=ch,
                   norm_type="IN")
    seed = 0 if name == "dense" else 2
    x = jax.random.normal(jax.random.key(seed), (b, t, ch))
    params = jax.jit(model.init)(jax.random.key(seed + 1), x)
    cfg = JaxModelConfig(tcn_repeats=repeats, tcn_blocks=blocks,
                         tcn_channels=ch)
    mesh = jax_make_mesh(axis="seq")
    want = jax.jit(lambda p, v: tcn_time_sharded(p, v, cfg, mesh))(
        params["params"], x)
    holder = torch.nn.Module()
    holder.tcn = TemporalConvNet(repeats, blocks, ch, "IN")
    sd = jax_to_state_dict({"tcn": params["params"]}, holder)
    sd = {k.removeprefix("tcn."): v for k, v in sd.items()}
    return (sd, np.ascontiguousarray(np.array(x).transpose(0, 2, 1)),
            np.asarray(want).transpose(0, 2, 1))


def _grads(model, x, proj):
    """Output, and the gradients of sum(output * proj) with respect to
    ``x`` and every parameter."""
    x = x.clone().requires_grad_(True)
    model.zero_grad(set_to_none=True)
    out = model(x)
    (out * proj).sum().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return out.detach(), x.grad.clone(), grads


def _rank(rank, world, rdv, out, cases):
    """One gloo rank: the SP TCN of each case and the SP MISO1 with their
    gradients, results to out/rank<r>.pt."""
    torch.set_num_threads(1)
    from misonet_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(f"file://{rdv}", world, rank, device="cpu")
    mesh = make_mesh(axis="seq")
    res = {}
    for (name, repeats, blocks, ch, _, _), (sd, x) in zip(CASES, cases):
        sp = TemporalConvNetSP(repeats, blocks, ch, "IN", mesh)
        sp.load_state_dict(sd)
        x = torch.from_numpy(x)
        proj = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
        res[name] = _grads(sp, x, proj)
    sp = make_miso1(ModelConfig(**SP_PLAN, sequence_parallel=True), 3,
                    device="cpu", sp_mesh=mesh)
    res["miso1"] = _miso1_grads(sp, *_miso1_inputs())
    torch.save(res, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def _miso1_inputs():
    rng = np.random.default_rng(4)
    shape = (2, 3, 64, 17)   # 32 frames a rank, dilations to 4
    mix = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    proj = rng.standard_normal((2, 2, 64, 17)) + 0j
    return (torch.from_numpy(mix.astype(np.complex64)),
            torch.from_numpy(proj.astype(np.complex64)))


def _miso1_grads(model, mix, proj):
    model.zero_grad(set_to_none=True)
    out = model(mix)
    torch.view_as_real(out * proj.conj()).sum().backward()
    return out.detach(), None, {k: p.grad.clone()
                                for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [_tcn_case(*c) for c in CASES]
    out = tmp_path_factory.mktemp("sp")
    ctx = mp.start_processes(
        _rank, args=(WORLD, out / "rdv", out, [(sd, x) for sd, x, _ in cases]),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish in {SPAWN_TIMEOUT} s")
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return cases, res


def _close_grads(got: dict, want: dict, tol=TOL):
    assert got.keys() == want.keys()
    top = max(v.abs().max().item() for v in want.values())
    for k in want:
        err = (got[k] - want[k]).abs().max().item() / top
        assert err <= tol, (k, err)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_sp_tcn_matches_local_and_jax(ranks, case):
    cases, res = ranks
    name, repeats, blocks, ch, _, _ = CASES[case]
    sd, x, jax_out = cases[case]
    local = TemporalConvNet(repeats, blocks, ch, "IN")
    local.load_state_dict(sd)
    proj = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    want_out, want_dx, want_grads = _grads(local, torch.from_numpy(x), proj)
    for r in res:
        out, dx, grads = r[name]
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(out.numpy(), jax_out, atol=TOL, rtol=TOL)
        _close_grads({"x": dx, **grads}, {"x": want_dx, **want_grads})
    for a, b in zip(res[0][name][2].values(), res[1][name][2].values()):
        assert torch.equal(a, b)
    assert torch.equal(res[0][name][1], res[1][name][1])


def test_sequence_parallel_through_model(ranks):
    """The SP MISO1 (same state_dict layout as the local one: both are
    seeded alike) against the local MISO1: output and every parameter's
    gradient."""
    _, res = ranks
    local = make_miso1(ModelConfig(**SP_PLAN), 3, device="cpu")
    want_out, _, want_grads = _miso1_grads(local, *_miso1_inputs())
    sp = make_miso1(ModelConfig(**SP_PLAN, sequence_parallel=True), 3,
                    device="cpu", sp_mesh=Mesh((0, 1), None))
    assert sp.state_dict().keys() == local.state_dict().keys()
    assert isinstance(sp.tcn, TemporalConvNetSP)
    for r in res:
        out, _, grads = r["miso1"]
        np.testing.assert_allclose(out.numpy(), want_out.numpy(),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        _close_grads(grads, want_grads)


def test_sp_tcn_raises_on_its_constraints():
    mesh = Mesh((0, 1), None, "seq")
    with pytest.raises(ValueError, match="IN outer norm"):
        TemporalConvNetSP(1, 2, 8, "gLN", mesh)
    sp = TemporalConvNetSP(1, 4, 8, "IN", mesh)
    with pytest.raises(ValueError, match="do not divide"):
        sp(torch.zeros(1, 8, 31))
    with pytest.raises(ValueError, match="halo of 8 frames"):
        sp(torch.zeros(1, 8, 14))
    # without a mesh the flag keeps the local TCN, as in the JAX package
    model = make_miso1(ModelConfig(**SP_PLAN, sequence_parallel=True), 3,
                       device="cpu")
    assert type(model.tcn) is TemporalConvNet
