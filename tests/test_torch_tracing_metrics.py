"""The benchmark's readers of the program's spans and counters
(``benchmark/metrics/``: decode_host_ms_per_req, decode_idle_ms_per_req,
syncs_per_req, decode_replays_per_req, data_wait_ms_per_step, optimizer_ms_per_step,
backward_idle_ms_per_step, syncs_per_step) on a hand-built run: a stand-in
for the trace's aggregate and the program's record filled under a CPU
profiler.  Each returns None where nothing was traced or the record is
empty, and otherwise its number per request or step."""

import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark import harness, trace  # noqa: E402
from misonet_tpu_torch.utils import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVE = ("decode_host_ms_per_req", "decode_idle_ms_per_req", "syncs_per_req",
         "decode_replays_per_req")
TRAIN = ("data_wait_ms_per_step", "optimizer_ms_per_step",
         "backward_idle_ms_per_step", "syncs_per_step")
US = 1_000


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _metric(name):
    return harness.Bench(ROOT).metric(name)


def _run(kernels=(), requests=2, steps=2, ranges=None):
    """A run whose traced stretch held ``requests`` "bench.request" spans,
    ``steps`` steps, the device ``kernels`` and the ranges' device
    seconds."""
    run = harness.Run({}, {}, {})
    agg = types.SimpleNamespace(spans={"bench.request": requests},
                                kernels=list(kernels), ranges=dict(ranges or {}))
    agg.range_seconds = types.MethodType(trace.Aggregate.range_seconds, agg)
    run.trace = agg
    run.stretch = {"count": steps}
    return run


def _record(names_ms, counts=None):
    """Outermost spans each holding one inner span, under a CPU profiler:
    [(outer, inner, ms the inner lasts)]; the counters ``counts``."""
    with profile(activities=[ProfilerActivity.CPU]):
        for outer, inner, ms in names_ms:
            with profiling.span(outer):
                with profiling.span(inner):
                    time.sleep(ms / 1e3)
        for name, n in (counts or {}).items():
            profiling.count(name, n)
    return profiling.records()["spans"]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_traced_reads_none(name):
    run = _run()
    run.trace = None
    assert _metric(name).read(run) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_empty_record_reads_none(name):
    assert profiling.records()["spans"] == []
    assert _metric(name).read(_run(kernels=[("k", 0, 10 * US)])) is None


def test_decode_host_ms_per_req():
    spans = _record([("serve.block", "miso1.decode", 2),
                     ("serve.block", "miso1.decode", 3)])
    want = sum(s.end_ns - s.start_ns for s in spans
               if s.name == "miso1.decode") / 1e6 / 2
    got = _metric("decode_host_ms_per_req").read(_run())
    assert got == pytest.approx(want) and got >= 2.5


def test_syncs_per_req_and_per_step():
    _record([("serve.block", "readback", 0)], {"sync": 6, "h2d": 3})
    assert _metric("syncs_per_req").read(_run(requests=3)) == 2.0
    assert _metric("syncs_per_step").read(_run(steps=4)) == 1.5


def test_decode_replays_per_req():
    _record([("serve.block", "miso1.decode", 0)] * 3, {"decode.replay": 3})
    assert _metric("decode_replays_per_req").read(_run(requests=3)) == 1.0
    # a program that counts no replay (no graph in its decode) reads None
    profiling.reset()
    _record([("serve.block", "miso1.decode", 0)], {"sync": 2})
    assert _metric("decode_replays_per_req").read(_run(requests=1)) is None


def test_syncs_read_zero_where_spans_ran_and_nothing_waited():
    _record([("train.step", "train.backward", 0)])
    assert _metric("syncs_per_step").read(_run()) == 0.0


def test_data_wait_ms_per_step():
    spans = _record([("train.step", "h2d", 1), ("train.step", "h2d", 2)])
    want = sum(s.end_ns - s.start_ns for s in spans if s.name == "h2d") / 1e6
    got = _metric("data_wait_ms_per_step").read(_run(steps=2))
    assert got == pytest.approx(want / 2)


def test_optimizer_ms_per_step_reads_the_ranges_device_time():
    _record([("train.step", "train.optimizer", 0)])
    run = _run(steps=4, ranges={"train.optimizer": 0.008, "stft": 1.0})
    assert _metric("optimizer_ms_per_step").read(run) == pytest.approx(2.0)
    assert _metric("optimizer_ms_per_step").read(_run(ranges={"stft": 1.0})) is None


@pytest.mark.parametrize("name,outer,inner,per", [
    ("decode_idle_ms_per_req", "serve.block", "miso1.decode", "requests"),
    ("backward_idle_ms_per_step", "train.step", "train.backward", "steps"),
])
def test_idle_is_put_down_to_the_inner_span(name, outer, inner, per):
    spans = _record([(outer, inner, 3), (outer, inner, 3)])
    kernels = []
    for s in spans:
        if s.name == inner:     # a 1 ms gap inside each inner span, busy
            kernels += [("k", s.start_ns, 100 * US),   # to just past its end
                        ("k", s.start_ns + 1100 * US,
                         s.end_ns - s.start_ns - 1090 * US)]
    # a 10 us gap, under the trace's floor, counts to no span
    _, start, dur = kernels[-1]
    kernels += [("k", start + dur + 10 * US, 50 * US)]
    got = _metric(name).read(_run(kernels=kernels, **{per: 4}))
    assert got == pytest.approx(2 * 1.0 / 4)
    # a record without the inner span reads None
    profiling.reset()
    _record([(outer, "other", 3)])
    assert _metric(name).read(_run(kernels=kernels, **{per: 4})) is None
