"""Cascade serving: closed-loop clients, each sending whole utterances to
``CascadeEvaluator.process`` (MISO1 decode, utterance-mode MVDR, MISO3; no
clean references), the served path of ``Test -t MISO3``.

Each client sends its next request when the last one has returned; client 0
runs on the calling thread, any others on threads of their own, as
``CascadeEvaluator.evaluate_corpus(workers=n)`` runs them.  A request's
latency is the host clock from the call to the returned waves.
"""

from __future__ import annotations

import threading
import time
import traceback

import numpy as np
import torch

from benchmark import program, traffic, work


class Session:
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 quant_int8: bool = False):
        from misonet_tpu_torch.inference.evaluate import CascadeEvaluator

        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, device
        t = cell["traffic"]
        self.sd = program.weights(cfg, seed, device)
        nets = program.nets(cfg, self.sd, device, quant_int8)
        _, stft, ds = program.configs(cfg)
        self.ev = CascadeEvaluator(
            nets["miso1"], stft, ds, enhance_model=nets["miso3"], joint=False,
            beamform_utterance=True, power_iters=cfg["mvdr"]["power_iters"])
        self.chunk = ds.chunk_samples
        self.fs = ds.fs
        self.pool = traffic.utterances(t, cfg, seed, device)
        self.orders = traffic.client_orders(t, seed)
        self.cursor = [0] * t["clients"]
        self.kept: dict[int, object] = {}
        frames = work.frames(cfg)
        per = work.nets(cfg)
        self.item_flops = {k: work.forward_flops(n, frames) for k, n in per.items()}
        # warm-up: every bucket of chunks the pool sends, twice
        chunks = [self._chunks(i) for i in range(len(self.pool))]
        for bucket in sorted({self._bucket(c) for c in chunks}):
            i = next(k for k, c in enumerate(chunks) if self._bucket(c) == bucket)
            for _ in range(2):
                self.ev.process(self.pool[i])
        torch.cuda.synchronize() if torch.device(device).type == "cuda" else None

    def _chunks(self, i: int) -> int:
        return -(-self.pool[i].shape[0] // self.chunk)

    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << (n - 1).bit_length()

    def _client(self, c: int, lock, records: list, errors: list,
                until: float | None, count: list | None) -> None:
        order = self.orders[c]
        while True:
            if until is not None and time.perf_counter() >= until:
                return
            if count is not None:
                with lock:
                    if count[0] <= 0:
                        return
                    count[0] -= 1
            i = int(order[self.cursor[c] % len(order)])
            self.cursor[c] += 1
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("bench.request"):
                    res = self.ev.process(self.pool[i])
            except Exception:  # a failed request counts, the run goes on
                errors.append(traceback.format_exc(limit=-4))
                continue
            t1 = time.perf_counter()
            records.append((i, t0, t1))
            self.kept.setdefault(i, res)

    def _drive(self, until=None, count=None):
        """All clients, client 0 on this thread (the profiler's), until the
        host clock reaches ``until`` or ``count`` requests have been sent."""
        records, errors, lock = [], [], threading.Lock()
        budget = None if count is None else [count]
        threads = [threading.Thread(target=self._client,
                                    args=(c, lock, records, errors, until, budget))
                   for c in range(1, len(self.orders))]
        for th in threads:
            th.start()
        self._client(0, lock, records, errors, until, budget)
        for th in threads:
            th.join()
        return records, errors

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        end = t0 + seconds
        records, errors = self._drive(until=end)
        done = [r for r in records if r[2] <= end]
        audio = sum(self.pool[i].shape[0] for i, _, _ in done) / self.fs
        flops = sum(self._request_flops(self._chunks(i)) for i, _, _ in done)
        return {"seconds": seconds, "attempted": len(records) + len(errors),
                "failed": len(errors), "errors": errors[:3],
                "latencies_ms": [(b - a) * 1e3 for _, a, b in done],
                "slices": slices([(a, b) for _, a, b in done], t0, seconds),
                "audio_s": audio, "flops": flops, "requests": len(done)}

    def _request_flops(self, chunks: int) -> int:
        """Model FLOPs of a request's ``chunks`` real chunks: MISO1 at M
        shifts, MISO3 per speaker; the bucket's padding is not counted."""
        ds = self.cfg["dataset"]
        m1, m3 = self.item_flops["miso1"], self.item_flops["miso3"]
        return chunks * (ds["num_ch"] * m1 + ds["num_spks"] * m3)

    def stretch(self, count: int) -> dict:
        """``count`` requests under the profiler; the raw record of what the
        card ran: each request's chunks and bucket, and each net's pass
        over the bucket (the kernels see its padded chunks)."""
        records, errors = self._drive(count=count)
        ds = self.cfg["dataset"]
        requests, passes = [], []
        for i, _, _ in records:
            n = self._chunks(i)
            nb = self._bucket(n)
            requests.append({"chunks": n, "bucket": nb})
            passes += [{"net": "miso1", "items": ds["num_ch"] * nb, "backward": False},
                       {"net": "miso3", "items": ds["num_spks"] * nb, "backward": False}]
        return {"count": len(records), "failed": len(errors),
                "requests": requests, "passes": passes}

    def _sample(self) -> list[int]:
        """A seeded sample of the requests served: the longest, then one of
        each bucket in turn, so that every bucket the window served has its
        share and a fault of one bucket reaches several sampled requests."""
        kept = sorted(self.kept)
        k = min(self.cell["check"]["requests"], len(kept))
        longest = max(kept, key=lambda i: self.pool[i].shape[0])
        groups: dict[int, list[int]] = {}
        for i in kept:
            if i != longest:
                groups.setdefault(self._bucket(self._chunks(i)), []).append(i)
        g = traffic.rng(self.seed, "sample")
        queues = [[int(i) for i in g.permutation(v)]
                  for _, v in sorted(groups.items())]
        sample = [longest]
        while len(sample) < k:
            for q in queues:
                if q and len(sample) < k:
                    sample.append(q.pop())
        return sample

    def check(self) -> list[tuple[str, float, float]]:
        """Held against the plain reference: a seeded sample of the requests
        served, with the longest and every bucket; each stage's largest
        relative L2 error, the second largest where ``check.stat`` says."""
        from benchmark.reference import serving

        self.ev = None
        torch.cuda.empty_cache() if torch.device(self.device).type == "cuda" else None
        sample = self._sample()
        refs = {}
        for name in self.cfg["nets"]:
            net = program.ref_net(self.cfg, name, self.device)
            net.load_state_dict(self.sd[name])
            refs[name] = net.eval()
        lim = self.cell["check"]["limits"]
        per, margins, ties = [], [], 0
        for i in sample:
            outs, m = serving.cascade(refs["miso1"], refs["miso3"], self.pool[i],
                                      self.cfg, self.device)
            p = self.kept[i]
            got = {"separated": p.separated, "beamformed": p.beamformed,
                   "enhanced": p.enhanced}
            per.append(nearest(got, outs, lim)[1])
            margins += m
            ties += len(outs) - 1
        readings = over_sample(per, self.cell["check"])
        self.notes = {"sample": sample,
                      "buckets": [self._bucket(self._chunks(i)) for i in sample],
                      "tie_variants": ties,
                      "margins_below": margins_below(margins),
                      "per_request": [{k: round(v, 5) for k, v in e.items()}
                                      for e in per]}
        return [(k, readings[k], lim[k]) for k in lim]


def over_sample(per: list[dict], check: dict) -> dict:
    """Each compared number over the sampled requests (or blocks): the
    largest, or the second largest where the cell's ``check.stat`` says
    ``second``."""
    stat = check.get("stat", {})
    return {k: float(sorted((e[k] for e in per), reverse=True)[
        1 if stat.get(k) == "second" and len(per) > 1 else 0])
        for k in check["limits"]}


def slices(spans: list, t0: float, seconds: float, n: int = 10) -> list:
    """[requests completed, their median latency in ms] in each n-th of the
    window, by completion: how the pace moved within a run."""
    out = [[] for _ in range(n)]
    for a, b in spans:
        out[min(int((b - t0) / seconds * n), n - 1)].append((b - a) * 1e3)
    return [[len(v), round(float(np.median(v)), 2) if v else None] for v in out]


def nearest(got: dict, variants: list, lim: dict) -> tuple[int, dict]:
    """The reference variant nearest to ``got`` over all keys (in units of
    their limits): its index, and each key's relative error against it."""
    errs = [{k: program.rel_err(got[k], v[k]) for k in lim} for v in variants]
    j = min(range(len(errs)), key=lambda j: max(errs[j][k] / lim[k] for k in lim))
    return j, errs[j]


def margins_below(margins) -> dict:
    m = np.asarray(margins)
    return {"min": float(m.min()) if m.size else None, "n": int(m.size),
            **{f"{t:g}": int((m < t).sum()) for t in (1e-4, 1e-3, 1e-2)}}
