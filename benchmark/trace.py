"""The traced stretch's aggregate, read from ``torch.profiler`` in memory
(no trace file is written).

Device work is the profiler's CUDA kernel, memcpy and memset events; the
host's launches are its CUDA runtime launch records, which the card never
drops (the device side may lose events; ``device_events_lost`` counts the
launches whose device event is missing).  Ranges are every
``torch.profiler.record_function`` name the stretch ran: the program's
("stft", "istft", "mvdr.scm", "mvdr.weights", ...) and the benchmark's own
("bench.request", "bench.step"); a range's device time is that of the
kernels its host spans launched, so a metric over a range the program adds
later needs no edit here.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cudaLaunchCooperativeKernel")


class Aggregate:
    """What the metric readers see of one profiled stretch.

    ``kernels``   [(name, start_ns, dur_ns)] device kernels by start
    ``device_ops`` {name: seconds} kernels, copies and fills
    ``launches``  host launch records
    ``ranges``    {range name: device seconds}, every range of the stretch
    ``spans``     {range name: host spans recorded} ("bench.request",
                  "bench.step": the requests or steps run on a thread the
                  profiler records)
    ``busy_s``    union of device activity; ``window_s`` the host wall time
    ``gaps``      [(host op, seconds)] idle stretches by what the host ran
    """

    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        events = prof.profiler.kineto_results.events()
        dev, host, launched, seen = [], [], set(), set()
        self.spans: dict[str, int] = {}
        for ev in events:
            name = ev.name()
            if _annotation(ev):
                # a range's span mirrored on the device's timeline, no work
                if ev.device_type() != DeviceType.CUDA:
                    self.spans[name] = self.spans.get(name, 0) + 1
                continue
            if ev.device_type() == DeviceType.CUDA:
                dev.append((name, ev.start_ns(), ev.duration_ns()))
                seen.add(ev.correlation_id())
            else:
                if any(name.startswith(k) for k in LAUNCHES):
                    launched.add(ev.correlation_id())
                host.append((name, ev.start_ns(), ev.duration_ns()))
        dev.sort(key=lambda e: e[1])
        self.kernels = [e for e in dev if not _is_copy(e[0])]
        self.launches = len(launched)
        self.device_events_lost = len(launched - seen)
        self.device_ops: dict[str, float] = {}
        for name, _, dur in dev:
            self.device_ops[name] = self.device_ops.get(name, 0.0) + dur / 1e9
        self.busy_s, self.gaps = _busy_and_gaps(dev, host)
        self.ranges = {}
        for e in prof.key_averages():
            if e.key in self.spans and getattr(e, "device_type", None) == DeviceType.CPU:
                us = getattr(e, "device_time_total", None)
                self.ranges[e.key] = (us if us is not None else e.cuda_time_total) / 1e6

    def kernel_seconds(self, names, trailing=()) -> float:
        """Device seconds of the kernels whose name holds one of ``names``,
        with each kernel named in ``trailing`` that directly follows one of
        them (a second pass the same call launches) counted to it."""
        total, owner = 0.0, False
        for name, _, dur in self.kernels:
            if any(k in name for k in names):
                total += dur / 1e9
                owner = True
            elif owner and any(k in name for k in trailing):
                total += dur / 1e9
            else:
                owner = False
        return total

    def range_seconds(self, names) -> float | None:
        """Device seconds under the named ranges; None where the stretch ran
        none of them."""
        got = [self.ranges[r] for r in names if r in self.ranges]
        return sum(got) if got else None

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in self.gaps[:10]]}


def _annotation(ev) -> bool:
    """A ``record_function`` span (the program's ranges, the benchmark's
    spans, the optimizer's), on the host's or the device's timeline."""
    flag = getattr(ev, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    return "user_annotation" in str(getattr(ev, "activity_type", lambda: "")())


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _busy_and_gaps(dev, host, min_gap_ns: int = 20_000):
    """Union of the device intervals, and the idle gaps between them summed
    by the innermost host op running where each gap starts."""
    busy, gaps = 0, []
    end = None
    for _, start, dur in dev:
        if end is None or start > end:
            if end is not None and start - end >= min_gap_ns:
                gaps.append((end, start - end))
            busy += dur
            end = start + dur
        elif start + dur > end:
            busy += start + dur - end
            end = start + dur
    by_name: dict[str, float] = {}
    if host and gaps:
        names = [h[0] for h in host]
        starts = np.array([h[1] for h in host], dtype=np.int64)
        ends = starts + np.array([h[2] for h in host], dtype=np.int64)
        for at, length in sorted(gaps, key=lambda g: -g[1])[:2000]:
            inside = np.flatnonzero((starts <= at) & (ends >= at))
            name = (names[inside[np.argmax(starts[inside])]] if inside.size
                    else "no host op")
            by_name[name] = by_name.get(name, 0.0) + length / 1e9
    return busy / 1e9, sorted(by_name.items(), key=lambda kv: -kv[1])


def roofline(run, kernels, trailing, flops: float, nbytes: float) -> float | None:
    """A kernel's share of its roofline in %: the least time the card could
    take for ``flops`` and ``nbytes`` (against the configuration's peak and
    HBM bandwidth, ``peaks.json``) over the device time of the kernels
    named ``kernels`` (and ``trailing`` passes, :meth:`Aggregate.kernel_seconds`).
    None where nothing was traced or no such kernel ran."""
    if run.trace is None or not (flops or nbytes):
        return None
    t = run.trace.kernel_seconds(kernels, trailing)
    if not t:
        return None
    p = run.peaks
    return 100.0 * max(flops / p[run.cfg["precision"]],
                       nbytes / p["hbm_bytes_per_s"]) / t


@contextlib.contextmanager
def profiled(on_card: bool = True):
    """Profile the enclosed block (CPU, and CUDA ``on_card``); yields a dict
    that gets ``prof`` and ``window_s`` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        sync()
        out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof
