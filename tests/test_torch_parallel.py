"""PyTorch port, data parallel over ``torch.distributed`` (parallel/mesh.py,
train/steps.py, train/trainer.py, beamforming/scm.py, dryrun.py), on the
CPU: two gloo ranks in spawned processes (spawned once for the file, a
``file://`` rendezvous under ``tmp_path``, a timeout of its own).

Each rank starts from a different init; ``replicate`` gives both rank 0's
parameters.  Then one MISO1 train step and one MISO3 enhancement step on
each rank's half of a batch of 4: the updated parameters are identical on
the two ranks and equal the port's single-process full-batch step within
1e-6 of max-abs (the gradients are averaged in another order; that step is
held to JAX in tests/test_torch_train.py, as JAX holds its DP step to one
device in tests/test_train_step.py:72).  Also: the DenseBlock weight stacks
see the broadcast, ``chunked_scm`` over the two ranks equals the unsharded
SCM, a one-epoch data-parallel ``SeparationTrainer`` gives the
single-process history and only rank 0 writes checkpoints, and
``dryrun_multichip(2)`` passes.  ``make_mesh_for_batch``'s divisor rule is
held to JAX's on the conftest's 8 CPU devices."""

import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from misonet_tpu.parallel.mesh import make_mesh_for_batch as jax_mesh_for_batch  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch.beamforming.scm import chunked_scm  # noqa: E402
from misonet_tpu_torch.models import make_miso1, make_miso3  # noqa: E402
from misonet_tpu_torch.models.blocks import init_parameters  # noqa: E402
from misonet_tpu_torch.models.flat_dense import DenseBlockFlat  # noqa: E402
from misonet_tpu_torch.parallel.mesh import mesh_size_for_batch  # noqa: E402
from misonet_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_enhance_train_step,
    make_optimizer,
    make_separate_train_step,
)
from misonet_tpu_torch.train.trainer import SeparationTrainer  # noqa: E402

WORLD = 2
SPAWN_TIMEOUT = 150   # seconds for both ranks, dryrun included
SMALL = tcfg.ModelConfig(
    num_bottleneck=4, en_channels=(8, 8, 8, 16), de_channels=(16, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=2, tcn_channels=16, compute_dtype="float32")
STFT = tcfg.StftConfig(fs=8000, length=32, overlap=24)
DS = tcfg.DatasetConfig(num_ch=3, num_ch_utilize=3, num_spks=2, ref_ch=0)
B, C, T, F = 4, 3, 16, 17
ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cx(rng, shape, scale=1.0):
    v = scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return torch.from_numpy(v.astype(np.complex64))


def _inputs():
    rng = np.random.default_rng(0)
    return {"mix": _cx(rng, (B, C, T, F)), "ref": _cx(rng, (B, 2, T, F), 0.1),
            "x": _cx(rng, (B, C + 2, T, F)), "y": _cx(rng, (B, 1, T, F), 0.1),
            "blocks": _cx(rng, (WORLD, C, T, F))}


def _wave_batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        src = 0.1 * rng.standard_normal((B, 2, 512)).astype(np.float32)
        gains = rng.uniform(0.3, 1.0, (B, 2, 3)).astype(np.float32)
        mix = np.einsum("bks,bkc->bsc", src, gains).astype(np.float32)
        out.append({"mix": mix, "ref": src})
    return out


def _step(kind, seed, batch, mesh=None):
    """One train step of a model initialized from ``seed`` (replicated
    from rank 0 under a mesh); returns its state_dict and metrics."""
    from misonet_tpu_torch.parallel import replicate

    gen = torch.Generator().manual_seed(seed)
    if kind == "miso1":
        model = make_miso1(SMALL, C, device="cpu", generator=gen)
        make, args = make_separate_train_step, (batch["mix"], batch["ref"])
    else:
        model = make_miso3(SMALL, C, device="cpu", generator=gen)
        make, args = make_enhance_train_step, (batch["x"], batch["y"])
    if mesh is not None:
        replicate(model, mesh)
    opt = make_optimizer(tcfg.OptimizerConfig(), model.parameters())
    state = create_train_state(model, opt)
    _, metrics = make(model, opt, mesh=mesh)(state, *args)
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {k: float(v) for k, v in metrics.items()})


def _trainer(folder, batches, mesh=None):
    model = make_miso1(SMALL, C, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    cfg = tcfg.TrainerConfig(epochs=1, save_folder=str(folder),
                             checkpoint_every=1, print_freq=100)
    return SeparationTrainer(model, cfg, tcfg.OptimizerConfig(), STFT, DS,
                             batches, batches, mesh=mesh)


def _rank(rank, world, rdv, out):
    """One gloo rank: every check of the file, results to out/rank<r>.pt."""
    torch.set_num_threads(1)
    from misonet_tpu_torch.dryrun import dryrun_multichip
    from misonet_tpu_torch.parallel import distributed, make_mesh, replicate
    from misonet_tpu_torch.parallel import shard_batch

    distributed.initialize(f"file://{rdv}", world, rank, device="cpu")
    mesh = make_mesh()
    res = {"index": mesh.index, "host": distributed.host_index(),
           "hosts": distributed.host_count()}
    batch = shard_batch(_inputs(), mesh)
    # a different init on every rank: the step replicates rank 0's
    res["miso1"] = _step("miso1", 1 + rank, batch, mesh)
    res["miso3"] = _step("miso3", 2 + rank, batch, mesh)
    res["scm"] = chunked_scm(batch["blocks"], mesh)

    block = DenseBlockFlat(16, 8, 12)
    init_parameters(block, torch.Generator().manual_seed(10 + rank))
    with torch.no_grad():
        res["stacks_before"] = [w.clone() for w in block.stacked_weights()]
        replicate(block, mesh)
        res["stacks_after"] = block.stacked_weights()
    res["stacks_want"] = block._stack()

    trainer = _trainer(out / f"ck{rank}", _wave_batches(), mesh)
    res["history"] = trainer.train()
    res["dryrun_loss"] = dryrun_multichip(world, device="cpu")
    torch.save(res, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    ctx = mp.start_processes(_rank, args=(WORLD, out / "rdv", out),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish in {SPAWN_TIMEOUT} s")
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]


def _max_abs(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max((a[k] - b[k]).abs().max().item() for k in a)


def test_ranks_know_their_place(ranks):
    _, res = ranks
    assert [(r["index"], r["host"], r["hosts"]) for r in res] == [
        (0, 0, 2), (1, 1, 2)]


@pytest.mark.parametrize("kind", ["miso1", "miso3"])
def test_dp_step_matches_the_full_batch_step(ranks, kind):
    """Both ranks end the step with the same parameters, equal to one
    process's step over the whole batch from rank 0's init; the metrics'
    loss is the full batch's."""
    _, res = ranks
    want_sd, want_metrics = _step(kind, 1 if kind == "miso1" else 2,
                                  _inputs())
    sd0, m0 = res[0][kind]
    sd1, m1 = res[1][kind]
    assert _max_abs(sd0, sd1) == 0.0 and m0 == m1
    assert _max_abs(sd0, want_sd) <= ATOL
    for k in ("loss", "grad_norm"):
        assert m0[k] == pytest.approx(want_metrics[k], rel=1e-5)


def test_stacked_weights_see_the_broadcast(ranks):
    """DenseBlockFlat caches its weight stacks by the weights' version; the
    broadcast of ``replicate`` moves the version, so rank 1's stacks become
    rank 0's."""
    _, res = ranks
    before = [r["stacks_before"] for r in res]
    assert not torch.equal(before[0][0], before[1][0])
    for r in res:
        for got, want in zip(r["stacks_after"], r["stacks_want"]):
            assert torch.equal(got, want)
    for a, b in zip(res[0]["stacks_after"], res[1]["stacks_after"]):
        assert torch.equal(a, b)
    for a, b in zip(res[0]["stacks_after"], before[0]):
        assert torch.equal(a, b)


def test_collective_scm_matches_unsharded(ranks):
    _, res = ranks
    want = chunked_scm(_inputs()["blocks"])
    for r in res:
        np.testing.assert_allclose(r["scm"].numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-5)
    assert torch.equal(res[0]["scm"], res[1]["scm"])


def test_dp_trainer_matches_one_process(ranks, tmp_path):
    """One epoch of SeparationTrainer over two batches of 4, each rank on
    its 2 rows: both ranks record the one-process history (global-mean
    losses), and only rank 0 wrote checkpoints."""
    out, res = ranks
    want = _trainer(tmp_path / "one", _wave_batches()).train()
    for r in res:
        for k in ("train", "val"):
            np.testing.assert_allclose(r["history"][k], want[k], rtol=1e-5)
    assert res[0]["history"] == res[1]["history"]
    assert sorted(p.name for p in (out / "ck0").iterdir())
    assert not (out / "ck1").exists()


def test_dryrun_multichip_on_two_ranks(ranks):
    _, res = ranks
    losses = [r["dryrun_loss"] for r in res]
    assert np.isfinite(losses).all() and losses[0] == losses[1]


@pytest.mark.parametrize("devices", [0, 1, 3, 8])
def test_mesh_for_batch_follows_jax(devices):
    """The largest divisor of the batch not above the device count (all 8
    of the conftest's CPU devices for 0), as JAX's make_mesh_for_batch."""
    for batch in range(1, 13):
        want = jax_mesh_for_batch(batch, devices).size
        assert mesh_size_for_batch(batch, devices or 8) == want, batch


def test_shard_batch_rows():
    """Rank k of n takes rows [k*B/n, (k+1)*B/n) of every array, as
    NamedSharding(P(axis)) places them; a batch that does not divide
    raises."""
    from misonet_tpu_torch.parallel import Mesh, shard_batch

    batch = {"a": np.arange(8), "b": (torch.arange(16).reshape(8, 2), 5)}

    class _Rank(Mesh):
        index = 2

    got = shard_batch(batch, _Rank((0, 1, 2, 3), None))
    assert got["a"].tolist() == [4, 5]
    assert got["b"][0].tolist() == [[8, 9], [10, 11]] and got["b"][1] == 5
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(np.arange(6), _Rank((0, 1, 2, 3), None))
