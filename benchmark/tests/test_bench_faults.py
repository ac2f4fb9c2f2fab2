"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the measured program on the CPU at the
tiny plan, with the rest of the run as the harness drives it."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    return harness.Bench(root, root / "benchmark")


def _run(bench, cell, seed=21):
    return harness.run_cell(bench, cell, seed, 0.3, False, "cpu", 0.0)


def _half_batch(monkeypatch):
    """The nets compute half their batch; the other half comes out zero."""
    from misonet_tpu_torch.models.miso import MISONet

    forward = MISONet.forward

    def half(self, x):
        out = forward(self, x)
        return torch.cat([out[: len(out) // 2], torch.zeros_like(out[len(out) // 2:])])

    monkeypatch.setattr(MISONet, "forward", half)


def _altered_answer(monkeypatch):
    """Every estimate the nets produce is 5 % off."""
    from misonet_tpu_torch.models.miso import MISONet

    forward = MISONet.forward
    monkeypatch.setattr(MISONet, "forward", lambda self, x: 1.05 * forward(self, x))


def _css_state_unchanged(monkeypatch):
    from misonet_tpu_torch.inference.css import StreamingCSS

    step = StreamingCSS.step

    def stuck(self, state, block):
        _, bf, m1 = step(self, state, block)
        return state, bf, m1

    monkeypatch.setattr(StreamingCSS, "step", stuck)


def _train_state_unchanged(monkeypatch):
    from misonet_tpu_torch.train.state import Optimizer, global_norm

    monkeypatch.setattr(Optimizer, "update", lambda self: global_norm(
        [p.grad for p in self.params if p.grad is not None]))


def _train_small_leaves_unchanged(monkeypatch):
    """The optimizer updates every leaf but the scalars (the PReLU slopes),
    which stay where they were: their change is far below the median
    leaf's, at which ``change`` is floored, so ``frozen`` has to see it."""
    from misonet_tpu_torch.train.state import Optimizer

    update = Optimizer.update

    def skip_small(self):
        small = [p for p in self.params if p.numel() == 1]
        kept = [p.detach().clone() for p in small]
        norm = update(self)
        with torch.no_grad():
            for p, k in zip(small, kept):
                p.copy_(k)
        return norm

    monkeypatch.setattr(Optimizer, "update", skip_small)


def _train_half_rows(monkeypatch):
    """The step's loss is the mean over the first half of the batch."""
    import misonet_tpu_torch.train as train

    make = train.make_separate_wave_train_step

    def factory(*a, **k):
        step = make(*a, **k)
        return lambda state, mix, ref: step(state, mix[: len(mix) // 2],
                                            ref[: len(ref) // 2])

    monkeypatch.setattr(train, "make_separate_wave_train_step", factory)


@pytest.mark.parametrize("cell", ["tiny.cascade", "tiny.css", "tiny.train"])
def test_sound_runs_are_correct(bench, cell):
    assert _run(bench, cell)["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny.cascade", _half_batch), ("tiny.cascade", _altered_answer),
    ("tiny.css", _half_batch), ("tiny.css", _altered_answer),
    ("tiny.css", _css_state_unchanged),
    ("tiny.train", _train_state_unchanged), ("tiny.train", _train_half_rows),
    ("tiny.train", _train_small_leaves_unchanged),
    ("tiny.train", _altered_answer),
], ids=lambda v: getattr(v, "__name__", v))
def test_faults_are_not_correct(bench, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(bench, cell)
    assert not r["correct"], r["checks"]
