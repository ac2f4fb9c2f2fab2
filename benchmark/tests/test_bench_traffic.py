"""The traffic pools: the same for one seed, different across seeds, and
the same set of sizes for every seed."""

import numpy as np
import torch

from benchmark import traffic
from benchmark.tests import tiny

SEEDS = (5, 2**31 + 77)
UTT = {"pool": 5, "min_s": 0.1, "max_s": 0.6, "clients": 2, "passes": 2}


def test_utterances_repeat_and_differ():
    a = traffic.utterances(UTT, tiny.CONFIG, SEEDS[0], 'cpu')
    b = traffic.utterances(UTT, tiny.CONFIG, SEEDS[0], 'cpu')
    c = traffic.utterances(UTT, tiny.CONFIG, SEEDS[1], 'cpu')
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(len(x) for x in a) == sorted(len(x) for x in c)
    assert not all(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(a, c))
    assert a[0].shape[1] == tiny.CONFIG["dataset"]["num_ch"]


def test_client_orders_cover_the_pool():
    for seed in SEEDS:
        for order in traffic.client_orders(UTT, seed):
            assert sorted(order[:UTT["pool"]]) == list(range(UTT["pool"]))
    assert not np.array_equal(traffic.client_orders(UTT, SEEDS[0])[0],
                              traffic.client_orders(UTT, SEEDS[1])[0])


def test_batches_and_scene():
    t = {"pool": 2, "batch": 3, "chunk_s": 0.25}
    a = traffic.batches(t, tiny.CONFIG, SEEDS[0], "cpu")
    b = traffic.batches(t, tiny.CONFIG, SEEDS[0], "cpu")
    c = traffic.batches(t, tiny.CONFIG, SEEDS[1], "cpu")
    assert a[0][0].shape == (3, 2000, 6) and a[0][1].shape == (3, 2, 2000)
    assert torch.equal(a[1][0], b[1][0]) and not torch.equal(a[1][0], c[1][0])
    rows = a[0][0].reshape(3, -1)
    assert not torch.equal(rows[0], rows[1])
    s = traffic.scene({"scene_s": 0.5}, tiny.CONFIG, SEEDS[1], "cpu")
    assert s.shape == (4000, 6) and np.isfinite(s).all()


def test_torch_seeds_fit_and_differ():
    seeds = {traffic.torch_seed(s, k) for s in SEEDS
             for k in ("weights_miso1", "weights_miso3")}
    assert len(seeds) == 4 and all(0 <= s < 2**63 for s in seeds)
