"""Spans, counters, traces and step timing (misonet_tpu/utils/profiling.py).

The reference's only performance instrumentation is wall-clock ms/batch
prints (trainer.py:216-221).  Here:

* **The record.**  ``span(name)`` marks a range of the program and
  ``count(name, n)`` counts an event (``sync``: the host waits for the card
  to drain; ``h2d``: a copy of host memory to the card; ``decode.capture``,
  ``decode.replay``: the MISO1 decode's CUDA graph captured, replayed;
  ``tfgridnet.rnn_steps``: a BLSTM call's sequence length;
  ``tfgridnet.relayout_bytes``: the bytes TF-GridNet's layout work writes
  in a forward), and
  ``node_span(node, name)`` marks an autograd node's run in the backward,
  on the thread that runs it.  All are gated on
  one flag, ``torch.autograd.profiler._is_profiler_enabled``, which is true
  while a ``torch.profiler`` profile runs (the benchmark's ``--trace 1``
  stretch, or :func:`trace` around any region) and false otherwise; no
  environment variable, flag or config key turns them on.  Off, ``span``
  reads the flag and returns a shared do-nothing context: no
  ``record_function``, no dispatcher call, no allocation.  On, it enters
  ``torch.profiler.record_function(name)`` (so the range and the device
  time of the kernels it launched reach the profiler's trace as before) and
  appends ``Span(name, start_ns, end_ns, parent, request, thread)`` to a
  list owned by the calling thread.  The outermost span on a thread opens a
  new request id and the spans inside it inherit it.  :func:`records` gives
  every thread's spans and the summed counters, :func:`reset` clears them.
* **The clock.**  Spans are stamped with ``time.time_ns()``, the clock of
  the profiler's own host and device events, so a span can be laid against
  the kernels of the same trace directly (:func:`idle_by_span`).  A span's
  stamps enclose its ``record_function`` event.
* :func:`trace`: a ``torch.profiler`` trace of a region, written as a
  Chrome trace (Perfetto, chrome://tracing) with the spans on the kernels'
  timeline.
* :class:`StepTimer`: audio-seconds per second over a rolling window of
  steps (``MetricWriter``'s ``perf/`` scalars).

The span names and what reads them are listed in the README's "PyTorch
port" section.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int    # index of the enclosing span in the same list; -1 if none
    request: int   # shared by an outermost span and every span inside it
    thread: int    # threading.get_ident() of the thread that ran it


class _Thread:
    """One thread's spans (lists, ``end_ns`` filled in on exit), the
    indices of its open spans and its counters."""

    def __init__(self):
        self.ident = threading.get_ident()
        self.spans: list[list] = []
        self.open: list[int] = []
        self.counts: dict[str, int] = {}


_local = threading.local()
_threads: list[_Thread] = []
_lock = threading.Lock()
_requests = itertools.count(1)


def _mine() -> _Thread:
    rec = getattr(_local, "rec", None)
    if rec is None:
        rec = _local.rec = _Thread()
        with _lock:
            _threads.append(rec)
    return rec


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "rf", "rec", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = self.rec = _mine()
        parent = rec.open[-1] if rec.open else -1
        req = rec.spans[parent][4] if parent >= 0 else next(_requests)
        self.entry = [self.name, time.time_ns(), 0, parent, req, rec.ident]
        rec.open.append(len(rec.spans))
        rec.spans.append(self.entry)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.entry[2] = time.time_ns()
        if self.rec.open:     # empty where reset() dropped the open spans
            self.rec.open.pop()
        return False


def span(name: str):
    """A context marking the range ``name``; records only while a profiler
    runs (see the module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def node_span(node, name: str) -> None:
    """Mark the run of the autograd ``node`` (a tensor's ``grad_fn``) in the
    backward as the range ``name``: a pre-hook on the node opens the span and
    a hook on it closes it, both on the thread that runs the node.  Hooks are
    set only while a profiler runs as the forward makes the node."""
    if node is None or not _profiler._is_profiler_enabled:
        return
    opened = []

    def enter(grad_outputs):
        opened.append(span(name))
        opened[-1].__enter__()

    def leave(grad_inputs, grad_outputs):
        if opened:
            opened.pop().__exit__(None, None, None)

    node.register_prehook(enter)
    node.register_hook(leave)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return
    counts = _mine().counts
    counts[name] = counts.get(name, 0) + n


def host_copy(device) -> None:
    """Count a copy of pageable host memory to ``device`` where it goes to
    a card: an ``h2d``, and a ``sync``, since PyTorch's copy waits for the
    stream to drain before it returns."""
    if torch.device(device).type == "cuda":
        count("h2d")
        count("sync")


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x).to(device, dtype)`` in an ``h2d`` span: the
    program's inputs going to the card (counted by :func:`host_copy` where
    they come from the host)."""
    with span("h2d"):
        x = torch.as_tensor(x)
        if x.device.type == "cpu":
            host_copy(device)
        return x.to(device, dtype)


def readback(x: torch.Tensor):
    """``x.cpu()`` in a ``readback`` span, counted as a ``sync`` where ``x``
    is on a card."""
    with span("readback"):
        if x.is_cuda:
            count("sync")
        return x.cpu()


def records() -> dict:
    """{"spans": [Span], "counts": {name: n}}: every thread's spans, thread
    by thread in the order each opened them (``parent`` indexes this list),
    and each counter summed over the threads.  A span still open has
    ``end_ns`` 0."""
    with _lock:
        threads = list(_threads)
    spans, counts = [], {}
    for rec in threads:
        base = len(spans)
        spans.extend(Span(n, s, e, p + base if p >= 0 else -1, r, t)
                     for n, s, e, p, r, t in list(rec.spans))
        for k, v in list(rec.counts.items()):
            counts[k] = counts.get(k, 0) + v
    return {"spans": spans, "counts": counts}


def reset() -> None:
    """Clear every thread's spans and counters; spans open at the time are
    dropped."""
    with _lock:
        for rec in _threads:
            rec.spans.clear()
            rec.open.clear()
            rec.counts.clear()


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's self time: its duration less that of its direct children
    (spans on one thread nest, so the children do not overlap)."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


MIN_GAP_NS = 20_000   # benchmark/trace.py's floor for an idle gap


def idle_by_span(kernels, spans: list[Span]) -> dict[str | None, float]:
    """The card's idle seconds by the innermost span open when each gap
    began.

    ``kernels`` are [(name, start_ns, dur_ns)] device kernels on the
    profiler's clock (copies and fills left out, so a copy counts as idle);
    ``spans`` those of one thread, which nest.  A gap is a stretch of at
    least ``MIN_GAP_NS`` between the union of the kernels' intervals; it is
    put down to the innermost span containing its start, or to None where
    none does."""
    # the innermost open span as a step function of time
    edges = sorted([(s.start_ns, 1, -s.end_ns, i) for i, s in enumerate(spans)]
                   + [(s.end_ns, 0, 0, i) for i, s in enumerate(spans)])
    times, owner, stack = [], [], []
    for t, opens, _, i in edges:
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        times.append(t)
        owner.append(spans[stack[-1]].name if stack else None)
    out: dict[str | None, float] = {}
    end = None
    for _, start, dur in sorted(kernels, key=lambda k: k[1]):
        if end is not None and start - end >= MIN_GAP_NS:
            k = bisect.bisect_right(times, end) - 1
            name = owner[k] if k >= 0 else None
            out[name] = out.get(name, 0.0) + (start - end) / 1e9
        end = start + dur if end is None else max(end, start + dur)
    return out


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a trace of the enclosed region into <logdir>/trace.json::

        with profiling.trace("logs/profile") as prof:
            state, metrics = train_step(state, mix, ref)
            torch.cuda.synchronize()

    The program's spans are ranges of the trace, on the kernels' timeline,
    and :func:`records` holds the region's spans afterwards (the record is
    cleared as the region starts).  Yields the ``torch.profiler.profile``
    (``prof.key_averages()`` gives time by kernel and by span)."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Rolling throughput tracker: feed (seconds_of_audio) per step, read
    audio-seconds/s (``MetricWriter``'s ``perf/step_ms`` and
    ``perf/audio_s_per_s``).  Host clock: time a step that ends in a value
    read back from the card (a step's loss), or synchronize before
    ``stop``."""

    def __init__(self, window: int = 50):
        self.window = window
        self.samples: list[tuple[float, float]] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.samples.append((dt, audio_seconds))
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return dt

    def discard(self) -> float:
        """Stop timing WITHOUT adding a sample to the throughput window
        (for steps with unknown audio content, which would otherwise
        deflate audio_seconds_per_second)."""
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return dt

    @property
    def audio_seconds_per_second(self) -> float:
        if not self.samples:
            return 0.0
        dt = sum(s[0] for s in self.samples)
        au = sum(s[1] for s in self.samples)
        return au / dt if dt > 0 else 0.0
