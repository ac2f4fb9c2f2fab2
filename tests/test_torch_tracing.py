"""PyTorch port: the span-and-counter record of ``utils/profiling.py``.

On the CPU: with no profiler running a CSS block and a train step record
nothing and enter no ``record_function``; under ``torch.profiler`` spans
nest (parent index, one request id per outermost span, self times), their
stamps agree with the profiler's own events for the same ranges, threads
keep their own stacks and ids, counters are gated like spans, the served
and training paths record their spans in order, and ``profiling.trace``
writes a Chrome trace holding them.  ``idle_by_span`` on hand-built
kernels.

On the card (marker ``cuda``): the ``sync`` counter equals the number of
CUDA sync-debug warnings over a CSS block and a bf16 train step, and a
span around one launch and a synchronize holds the kernel's device start.
This file imports no JAX (``--noconftest`` on a machine without it)."""

import json
import re
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from misonet_tpu_torch.config import (  # noqa: E402
    DatasetConfig,
    ModelConfig,
    OptimizerConfig,
    StftConfig,
)
from misonet_tpu_torch.inference.css import StreamingCSS  # noqa: E402
from misonet_tpu_torch.inference.evaluate import CascadeEvaluator  # noqa: E402
from misonet_tpu_torch.models import make_miso1, make_miso3  # noqa: E402
from misonet_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_optimizer,
    make_separate_wave_train_step,
)
from misonet_tpu_torch.utils import profiling  # noqa: E402

SMALL = ModelConfig(
    num_bottleneck=4, en_channels=(8, 8, 8, 16), de_channels=(16, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=2, tcn_channels=16, compute_dtype="float32",
)
STFT = StftConfig(fs=8000, length=32, overlap=24)  # 17 bins
DS = DatasetConfig(num_ch=3, num_ch_utilize=3, num_spks=2, ref_ch=0,
                   chunk_time=0.25, least_time=0.125)  # 2000-sample chunks
ADAM_CLIP = OptimizerConfig(name="adam", lr=1e-3, clipping=True, max_norm=5.0)

CSS_BLOCK = ["serve.block", "h2d", "stft", "miso1.decode", "css.update",
             "mvdr.scm", "mvdr.scm", "mvdr.weights", "istft", "readback",
             "istft", "readback"]
TRAIN_STEP = ["train.step", "h2d", "h2d", "stft", "stft", "train.forward",
              "train.backward", "train.optimizer"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def served():
    """A tiny CPU MISO1 in a CSS stream and a clipped Adam wave train step,
    each run once (the first call's one-off costs out of the way)."""
    torch.manual_seed(0)
    model = make_miso1(SMALL, DS.num_ch, DS.num_spks, device="cpu")
    css = StreamingCSS(model, STFT, DS)
    rng = np.random.default_rng(0)
    block = rng.standard_normal((DS.chunk_samples, DS.num_ch)).astype(np.float32)
    opt = make_optimizer(ADAM_CLIP, model.parameters())
    state = create_train_state(model, opt)
    step = make_separate_wave_train_step(model, opt, STFT)
    mix = rng.standard_normal((2, DS.chunk_samples, DS.num_ch)).astype(np.float32)
    ref = rng.standard_normal((2, DS.num_spks, DS.chunk_samples)).astype(np.float32)
    css_state = css.init_state(DS.num_spks)
    profiling.reset()

    class Paths:
        def block(self):
            nonlocal css_state
            css_state, bf, m1 = css.process_block(css_state, block)
            return bf, m1

        def step(self):
            return step(state, mix, ref)

    paths = Paths()
    paths.block()
    paths.step()
    return paths


def _names(spans):
    return [s.name for s in spans]


def test_off_records_nothing_and_enters_no_record_function(served, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    served.block()
    served.step()
    profiling.count("sync")
    with profiling.span("outside"):
        pass
    assert profiling.records() == {"spans": [], "counts": {}}


def test_off_span_is_one_shared_object():
    assert profiling.span("a") is profiling.span("b")


def test_spans_nest_with_parents_requests_and_self_times():
    with _cpu_profile():
        with profiling.span("a"):
            time.sleep(0.002)
            with profiling.span("b"):
                with profiling.span("c"):
                    time.sleep(0.003)
            with profiling.span("d"):
                time.sleep(0.001)
        with profiling.span("e"):
            pass
    spans = profiling.records()["spans"]
    assert _names(spans) == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    a, b, c, d, e = spans
    assert a.request == b.request == c.request == d.request != e.request
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    own = profiling.self_ns(spans)
    dur = [s.end_ns - s.start_ns for s in spans]
    assert own[0] == dur[0] - dur[1] - dur[3]
    assert own[1] == dur[1] - dur[2]
    assert own[2] == dur[2] and own[3] == dur[3]
    assert own[0] >= 2_000_000 and own[2] >= 3_000_000


def test_span_stamps_agree_with_the_profilers_events():
    names = [f"probe.{k}" for k in range(5)]
    with _cpu_profile() as prof:
        for name in names:
            with profiling.span(name):
                torch.ones(1000).cumsum(0)
                time.sleep(0.001)
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name() in names}
    spans = profiling.records()["spans"]
    assert _names(spans) == names
    for s in spans:
        ev = events[s.name]
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert abs(s.start_ns - start) < 1_000_000, (s, start)
        assert abs(s.end_ns - end) < 1_000_000, (s, end)
        assert s.start_ns <= start and end <= s.end_ns


def test_threads_keep_their_own_stacks_and_requests():
    inside = threading.Barrier(2, timeout=30)
    done = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"{tag}.outer"):
            inside.wait()          # both outer spans open at once
            with profiling.span(f"{tag}.inner"):
                profiling.count("sync")
            done.wait()

    with _cpu_profile():
        threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    rec = profiling.records()
    spans = rec["spans"]
    by_name = {s.name: s for s in spans}
    assert set(by_name) == {"x.outer", "x.inner", "y.outer", "y.inner"}
    for tag in "xy":
        outer, inner = by_name[f"{tag}.outer"], by_name[f"{tag}.inner"]
        assert spans[inner.parent].name == f"{tag}.outer"
        assert outer.parent == -1
        assert inner.request == outer.request
        assert inner.thread == outer.thread
    assert by_name["x.outer"].request != by_name["y.outer"].request
    assert by_name["x.outer"].thread != by_name["y.outer"].thread
    assert rec["counts"] == {"sync": 2}


def test_counters_are_gated():
    profiling.count("sync")
    profiling.count("h2d", 3)
    profiling.host_copy("cuda")
    assert profiling.records()["counts"] == {}
    with _cpu_profile():
        profiling.count("sync")
        profiling.count("h2d", 3)
        profiling.host_copy("cuda")
        profiling.host_copy("cpu")
    assert profiling.records()["counts"] == {"sync": 2, "h2d": 4}
    profiling.reset()
    assert profiling.records() == {"spans": [], "counts": {}}


def test_css_block_and_train_step_record_their_spans_in_order(served):
    with _cpu_profile():
        served.block()
        served.step()
    spans = profiling.records()["spans"]
    # the CPU's MVDR weights run the plain functions, which mark the
    # power iteration inside "mvdr.weights"
    names = [n for n in _names(spans) if n != "mvdr.power_iteration"]
    assert names == CSS_BLOCK + TRAIN_STEP
    block, step = spans[0], spans[names.index("train.step") + 1]
    assert block.name == "serve.block" and step.name == "train.step"
    assert block.request != step.request
    for s in spans:
        top = s
        while top.parent >= 0:
            top = spans[top.parent]
        assert top.name in ("serve.block", "train.step")
        assert s.request == top.request
    by = {s.name: s for s in spans}
    assert spans[by["mvdr.weights"].parent].name == "css.update"
    assert spans[by["train.optimizer"].parent].name == "train.step"
    # on the CPU no copy goes to a card and nothing waits for one
    assert profiling.records()["counts"] == {}


def test_cascade_request_records_its_spans():
    torch.manual_seed(1)
    miso1 = make_miso1(SMALL, DS.num_ch, DS.num_spks, device="cpu")
    miso3 = make_miso3(SMALL, DS.num_ch, device="cpu")
    ev = CascadeEvaluator(miso1, STFT, DS, enhance_model=miso3)
    wave = (np.random.default_rng(2)
            .standard_normal((2 * DS.chunk_samples - 300, DS.num_ch))
            .astype(np.float32))
    with _cpu_profile():
        ev.process(wave)
    spans = profiling.records()["spans"]
    names = _names(spans)
    assert names[0] == "serve.request" and spans[0].parent == -1
    for name in ("h2d", "miso1.decode", "mvdr.weights", "enhance", "readback"):
        assert name in names, name
    assert names.count("readback") == 3     # separated, beamformed, enhanced
    assert len({s.request for s in spans}) == 1


def test_trace_writes_the_spans_into_a_chrome_trace(served, tmp_path):
    with profiling.trace(tmp_path / "prof"):
        served.block()
    spans = profiling.records()["spans"]
    assert _names(spans)[0] == "serve.block"
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert set(CSS_BLOCK) <= names


def _span(name, start, end, parent=-1):
    return profiling.Span(name, start, end, parent, 1, 7)


def test_idle_is_put_down_to_the_innermost_open_span():
    us = 1_000
    spans = [_span("outer", 0, 1000 * us), _span("inner", 100 * us, 400 * us, 0)]
    kernels = [
        ("k", 50 * us, 10 * us),     # gap 60 -> 150 us: begins in outer
        ("k", 150 * us, 50 * us),    # gap 200 -> 300: inner
        ("k", 300 * us, 5 * us),     # gap 305 -> 315 (10 us): under the floor
        ("k", 315 * us, 5 * us),     # gap 320 -> 900: inner
        ("k", 900 * us, 20 * us),    # gap 920 -> 1200: outer
        ("k", 1200 * us, 10 * us),   # gap 1210 -> 1300: no span
        ("k", 1300 * us, 10 * us),
    ]
    idle = profiling.idle_by_span(kernels, spans)
    assert idle == pytest.approx({"outer": 370e-6, "inner": 680e-6,
                                  None: 90e-6})
    # overlapping kernels form one busy interval
    assert profiling.idle_by_span([("k", 0, 90 * us), ("k", 10 * us, 20 * us),
                                   ("k", 150 * us, 1)], spans) == \
        pytest.approx({"outer": 60e-6})


def test_the_port_marks_ranges_only_through_span():
    root = Path(profiling.__file__).resolve().parents[1]
    bare = [str(p) for p in root.rglob("*.py")
            if p.name != "profiling.py"
            and re.search(r"record_function\(", p.read_text())]
    assert bare == []


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.cuda.set_sync_debug_mode(0)


def _sync_warnings(fn) -> tuple[int, int]:
    """(sync-debug warnings, the ``sync`` counter) over one call of
    ``fn`` under a CPU profiler (which turns the counters on)."""
    torch.cuda.synchronize()
    profiling.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with _cpu_profile():
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    return len(syncs), profiling.records()["counts"].get("sync", 0)


@pytest.mark.cuda
def test_sync_counter_matches_cuda_sync_debug(cuda):
    """A full-width bf16 CSS block and a bf16 wave train step at batch 2
    (clipped Adam), each after a warm-up call under the same profiler (the
    profiler's first start in a process synchronizes once itself)."""
    torch.manual_seed(0)
    cfg = ModelConfig(compute_dtype="bfloat16")
    stft, ds = StftConfig(), DatasetConfig()
    model = make_miso1(cfg, ds.num_ch, ds.num_spks, device=cuda)
    css = StreamingCSS(model, stft, ds)
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((2, ds.chunk_samples, ds.num_ch)).astype(np.float32)
    state = css.init_state(ds.num_spks)
    _sync_warnings(lambda: css.process_block(state, blocks[0]))
    got = _sync_warnings(lambda: css.process_block(state, blocks[1]))
    assert got[0] == got[1] and got[0] > 0, got

    opt = make_optimizer(ADAM_CLIP, model.parameters())
    tstate = create_train_state(model, opt)
    step = make_separate_wave_train_step(model, opt, stft)
    mix = rng.standard_normal((2, ds.chunk_samples, ds.num_ch)).astype(np.float32)
    ref = rng.standard_normal((2, ds.num_spks, ds.chunk_samples)).astype(np.float32)
    _sync_warnings(lambda: step(tstate, mix, ref))
    got = _sync_warnings(lambda: step(tstate, mix, ref))
    assert got[0] == got[1] and got[0] > 0, got


@pytest.mark.cuda
def test_span_holds_its_kernels_device_start(cuda):
    """The device start of the kernel launched inside a span (matched to
    its host launch record by correlation id) lies within the span's
    stamps.  On the card's machine the profiler can lose a window's first
    device events: the window opens with marker kernels and a pause, and
    is retaken (3 tries) where the kernel's device event is missing."""
    from torch.autograd import DeviceType

    x = torch.randn(1 << 22, device=cuda)
    (x * 2).sum()
    torch.cuda.synchronize()
    for _ in range(3):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
            with profiling.span("probe"):
                y = x * 3.0
                torch.cuda.synchronize()
        del y
        (s,) = profiling.records()["spans"]
        events = prof.profiler.kineto_results.events()
        launched = {ev.correlation_id() for ev in events
                    if ev.device_type() != DeviceType.CUDA
                    and "LaunchKernel" in ev.name()
                    and s.start_ns <= ev.start_ns() <= s.end_ns}
        starts = [ev.start_ns() for ev in events
                  if ev.device_type() == DeviceType.CUDA
                  and ev.correlation_id() in launched]
        if starts:
            break
    assert launched, "no launch recorded inside the span"
    assert starts, "the kernel's device event was lost in 3 windows"
    assert all(s.start_ns <= t <= s.end_ns for t in starts), (s, starts)
