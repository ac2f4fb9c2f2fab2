"""The port's MISO1 decode helpers on the CPU (inference/separate.py):
``align_slots`` against the JAX package's and against every permutation
tried by hand, its permutation tables copied from the host once, the
state that keys the decode's CUDA graphs, the per-thread launch tally a
capture reads, and the CPU decode's eager path, which never builds a graph
(the graphs themselves run on the card: tests/test_torch_cuda.py)."""

import dataclasses
import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from misonet_tpu.inference.separate import align_slots as jax_align_slots  # noqa: E402
from misonet_tpu_torch.config import ModelConfig  # noqa: E402
from misonet_tpu_torch.inference import separate  # noqa: E402
from misonet_tpu_torch.models import make_miso1  # noqa: E402
from misonet_tpu_torch.ops.kernels import build  # noqa: E402

NARROW = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                     de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                     tcn_blocks=2, tcn_channels=16)


@pytest.mark.parametrize("s", [2, 3])
def test_align_slots_matches_the_jax_package(s):
    rng = np.random.default_rng(s)
    dist = rng.uniform(0, 1, (4, 5, s, s)).astype(np.float32)
    got = separate.align_slots(torch.from_numpy(dist)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_align_slots(
        jnp.asarray(dist))))
    # each row the permutation of least summed cost, tried one by one
    for idx, d in zip(got.reshape(-1, s), dist.reshape(-1, s, s)):
        best = min(itertools.permutations(range(s)),
                   key=lambda p: sum(d[i, p[i]] for i in range(s)))
        assert tuple(idx) == best


@pytest.mark.parametrize("s", [2, 3])
def test_align_slots_copies_its_tables_once(s, monkeypatch):
    """The one-hot and its permutation table come from the host at the
    first call per (S, device, dtype) and stay on the device after it."""
    copies = []
    monkeypatch.setattr(separate.profiling, "host_copy", copies.append)
    separate._perm_tables.cache_clear()
    for _ in range(3):
        separate.align_slots(torch.rand(2, s, s))
    assert copies == [torch.device("cpu")]
    separate.align_slots(torch.rand(2, s, s, dtype=torch.float64))
    assert len(copies) == 2


def test_graph_key_follows_the_models_tensors():
    """The model state the decode's graphs stand for changes with a
    ``load_state_dict``, an in-place step and a ``.data`` swap, and with
    nothing else."""
    model = make_miso1(NARROW, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    other = make_miso1(NARROW, device="cpu",
                       generator=torch.Generator().manual_seed(1)).state_dict()
    graphs = separate.DecodeGraphs(model, None)
    seen = [graphs._model_state()]
    assert graphs._model_state() == seen[0]
    model.load_state_dict(other)
    seen.append(graphs._model_state())
    p = next(model.parameters())
    with torch.no_grad():
        p.mul_(0.5)
    seen.append(graphs._model_state())
    p.data = p.data.clone()
    seen.append(graphs._model_state())
    assert len(set(seen)) == len(seen) == 4
    assert len(seen[0][0]) == len(list(model.parameters()))


def test_graph_key_follows_the_input_mode_and_config():
    """A graph's key changes with the input's shape and dtype, with
    ``model.training`` and with ``model.cfg`` (the forward reads its fused
    or plain path and int8 from it), and with nothing else."""
    model = make_miso1(NARROW, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    graphs = separate.DecodeGraphs(model.eval(), None)
    x = torch.zeros(1, 6, 8, 129, dtype=torch.complex64)
    keys = [graphs.key(x), graphs.key(torch.zeros_like(x)),
            graphs.key(x[:, :, :4]), graphs.key(x.to(torch.complex128))]
    model.train()
    keys.append(graphs.key(x))
    model.eval()
    keys.append(graphs.key(x))
    for change in ({"flat_dense": False}, {"quant_int8": True}):
        model.cfg = dataclasses.replace(NARROW, **change)
        keys.append(graphs.key(x))
    model.cfg = dataclasses.replace(NARROW)
    keys.append(graphs.key(x))
    assert keys[0] == keys[1] == keys[5] == keys[8]
    assert len({keys[0], *keys[2:5], keys[6], keys[7]}) == 6


def test_launch_tally_counts_this_threads_launches():
    """A tally holds the launches its own thread counted while it was
    open, not another thread's; ``add_launches`` moves the counters by
    it."""
    def wrapper():
        pass

    wrapper.launches = 0
    other = threading.Thread(
        target=lambda: [build.count_launch(wrapper, "launches")
                        for _ in range(5)])
    with build.tally() as mine:
        build.count_launch(wrapper, "launches")
        other.start()
        other.join()
        build.count_launch(wrapper, "launches")
    build.count_launch(wrapper, "launches")
    assert mine == {(wrapper, "launches"): 2} and wrapper.launches == 8
    build.add_launches(mine, -1)
    assert wrapper.launches == 6


def test_cpu_decode_builds_no_graph(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU decode built a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    model = make_miso1(NARROW, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    decode = separate.make_full_array_decode(model, 6)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((1, 6, 6, 129))
                          + 1j * rng.standard_normal((1, 6, 6, 129))
                          ).astype(np.complex64))
    outs = [decode(x) for _ in range(3)]
    assert outs[0].shape == (1, 2, 6, 6, 129)
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert decode.graphs.entries == {}
