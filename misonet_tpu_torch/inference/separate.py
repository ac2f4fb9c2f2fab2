"""MISO1 inference: circular-shift full-array decode + PIT alignment
(misonet_tpu/inference/separate.py; reference MISO1_Inference,
tester.py:201-255).

All M microphone shifts ride the batch axis of ONE forward; each shifted
run's speaker order is aligned to the reference-mic run by minimum
magnitude distance, per (shift, batch) element.

On the card the decode replays a CUDA graph: its ~1,300 launches at a
fixed input cost one ``cudaGraphLaunch`` instead of as many host calls
(:class:`DecodeGraphs`).  CPU inputs run the eager decode."""

from __future__ import annotations

import functools
import operator
import threading

import torch

from misonet_tpu_torch.losses import _perm_one_hot
from misonet_tpu_torch.ops.kernels import build
from misonet_tpu_torch.utils import profiling


@functools.cache
def _perm_tables(s: int, device: torch.device, dtype: torch.dtype):
    """(the one-hot of every permutation of S slots [S!, S, S], the
    candidate each slot takes under each of them [S!, S]) on ``device``:
    copied from the host once per (S, device, dtype), so no later call
    waits for the card (nor can break the capture of a CUDA graph).  Made
    outside inference mode, so autograd may read them too."""
    profiling.host_copy(device)
    with torch.inference_mode(False):
        one_hot = torch.as_tensor(_perm_one_hot(s), device=device,
                                  dtype=dtype)
        return one_hot, torch.argmax(one_hot, dim=2)


def align_slots(dist: torch.Tensor) -> torch.Tensor:
    """Minimum-cost slot assignment: dist [..., S, S] with dist[..., slot,
    candidate] -> int64 [..., S], the candidate chosen for each slot under
    the best global permutation (tester.py:137-147)."""
    one_hot, perms = _perm_tables(dist.shape[-1], dist.device, dist.dtype)
    per_perm = torch.einsum("...ij,pij->...p", dist, one_hot)
    return perms[torch.argmin(per_perm, dim=-1)]


def magnitude(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.real**2 + x.imag**2)


def make_full_array_decode(model, num_mics: int, ref_ch: int = 0):
    """Build the full-array decode: mix [B, C, T, F] complex ->
    [B, S, C, T, F] complex, where output channel c is each speaker's
    estimated image at mic c.  Runs without autograd; on the card through
    :class:`DecodeGraphs` (the returned function's ``graphs``)."""

    def forward(mix: torch.Tensor) -> torch.Tensor:
        b, m, t, f = mix.shape
        # run `sh` puts mic `sh` first and estimates the images at mic `sh`
        shifts = torch.stack(
            [torch.roll(mix, -sh, dims=1) for sh in range(num_mics)]
        )                                                     # [M, B, C, T, F]
        est = model(shifts.reshape(num_mics * b, m, t, f))
        s = est.shape[1]
        est = est.reshape(num_mics, b, s, t, f)              # [M, B, S, T, F]
        mag = magnitude(est)
        dist = (mag[ref_ch][None, :, :, None] - mag[:, :, None]).abs().sum(
            dim=(-2, -1)
        )                                                     # [M, B, S, S]
        idx = align_slots(dist)                               # [M, B, S]
        aligned = torch.take_along_dim(est, idx[..., None, None], dim=2)
        return aligned.permute(1, 2, 0, 3, 4)                 # [B, S, M, T, F]

    graphs = DecodeGraphs(model, forward)

    @torch.inference_mode()
    def decode(mix: torch.Tensor) -> torch.Tensor:
        if mix.shape[1] != num_mics:
            raise ValueError(f"expected {num_mics} mics, got {mix.shape[1]}")
        with profiling.span("miso1.decode"):
            return graphs(mix) if mix.is_cuda else forward(mix)

    decode.graphs = graphs
    return decode


# one capture at a time in the process (torch.cuda.graph's condition)
_CAPTURE = threading.Lock()
_VERSION = operator.attrgetter("_version")


class DecodeGraphs:
    """The decode of CUDA inputs as one CUDA graph per key.

    The key is the input's (shape, dtype, device), ``model.training`` and
    ``model.cfg`` (the forward picks its path from the config: fused or
    plain, int8 or not); the graphs stand for one state of the model's
    tensors, each parameter
    and buffer by (id, storage, ``_version``): a ``load_state_dict``, an
    optimizer step or a ``.to`` between calls leaves them stale (their
    packed and stacked weights would be), and the next call drops them,
    pools and all.  At a key, a thread's first call runs eagerly (it fills
    the weight packs, the permutation tables, the allocator, the library
    and the thread's cuDNN and cuBLAS handles); the next call captures
    ``forward`` in the graph's own pool on a side stream and replays it;
    later calls, from any thread, copy the input into the graph's,
    replay on the caller's stream and return a clone of the graph's output,
    so no caller holds the buffer that the next replay overwrites.

    Threads share a key's graph: each call holds the key's lock from the
    copy in to the clone out, and its stream waits for the previous
    replay's clone (an event), so two callers' replays never overlap.
    Captures run one at a time, with ``capture_error_mode="thread_local"``,
    so that another thread's launches meanwhile cannot break them.  A
    capture that fails anyway leaves its key as it found it and the call
    runs eagerly; the key's next call captures again.

    The kernels' launch counters keep counting executions: the launches a
    capture records (this thread's, :func:`build.tally`) are taken back
    from the counters, and added again at each replay.  Counted in the
    program's record: ``decode.capture`` and ``decode.replay``."""

    def __init__(self, model, forward):
        self.model, self.forward = model, forward
        self.lock = threading.Lock()
        self.entries: dict = {}   # key -> _Graph
        self.state = None         # the model's tensors the entries stand for
        self._dicts = None

    def _model_state(self) -> tuple:
        # the modules' own dicts see a tensor replaced in place
        if self._dicts is None:
            self._dicts = [d for mod in self.model.modules()
                           for d in (mod._parameters, mod._buffers) if d]
        vals = [v for d in self._dicts for v in d.values() if v is not None]
        try:
            versions = tuple(map(_VERSION, vals))
        except RuntimeError:    # inference tensors keep no version counter
            versions = tuple(-1 if v.is_inference() else v._version
                             for v in vals)
        return (tuple(map(id, vals)), tuple(map(torch.Tensor.data_ptr, vals)),
                versions)

    def key(self, mix: torch.Tensor) -> tuple:
        return (tuple(mix.shape), mix.dtype, mix.device, self.model.training,
                getattr(self.model, "cfg", None))

    def __call__(self, mix: torch.Tensor) -> torch.Tensor:
        state = self._model_state()
        key = self.key(mix)
        with self.lock:
            stale = []
            if state != self.state:
                stale, self.entries, self.state = list(
                    self.entries.values()), {}, state
            entry = self.entries.get(key)
            if entry is None:
                entry = self.entries[key] = _Graph()
        for old in stale:
            old.drop()
        with torch.cuda.device(mix.device):
            return entry.run(self.forward, mix)


class _Graph:
    """One key's graph, captured by a thread that has run the key eagerly
    (a capture cannot create the thread's cuDNN or cuBLAS handle)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.warm = threading.local()
        self.graph = None
        self.static_in = self.static_out = None
        self.launches: dict = {}
        self.done = torch.cuda.Event()   # recorded after each replay's clone

    def run(self, forward, mix):
        with self.lock:
            if self.graph is None:
                if not getattr(self.warm, "done", False):
                    self.warm.done = True
                    return forward(mix)
                if not self._capture(forward, mix):
                    return forward(mix)
            return self._replay(mix)

    def _capture(self, forward, mix) -> bool:
        """Capture ``forward``; False, with nothing kept, if that failed."""
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE, build.tally() as launched:
            try:
                with torch.cuda.graph(graph,
                                      stream=torch.cuda.Stream(mix.device),
                                      capture_error_mode="thread_local"):
                    static_in = torch.empty(mix.shape, dtype=mix.dtype,
                                            device=mix.device)
                    static_out = forward(static_in)
            except RuntimeError:
                return False
            finally:
                build.add_launches(launched, -1)   # recorded, not run
        self.graph, self.launches = graph, launched
        self.static_in, self.static_out = static_in, static_out
        profiling.count("decode.capture")
        return True

    def _replay(self, mix):
        stream = torch.cuda.current_stream()
        stream.wait_event(self.done)     # none before the first record
        self.static_in.copy_(mix)
        self.graph.replay()
        out = self.static_out.clone()
        self.done.record(stream)
        build.add_launches(self.launches)
        profiling.count("decode.replay")
        return out

    def drop(self):
        """Free the graph and its pool once its last replay is over."""
        with self.lock:
            self.done.synchronize()
            self.graph = self.static_in = self.static_out = None
