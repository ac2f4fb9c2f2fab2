"""decode_replays_per_req: the program's "decode.replay" counter (each
replay of the MISO1 decode's CUDA graph, ``inference/separate.py``) per
request of the traced stretch (the benchmark's "bench.request" spans).

Read from the program's own record (``utils/profiling.records()``), which
holds only the traced stretch.  None where nothing was traced, where the
program has no such record or recorded no span, or where it counted no
replay (a program whose decode has no graph)."""


def read(run):
    if run.trace is None:
        return None
    n = run.trace.spans.get("bench.request", 0)
    try:
        from misonet_tpu_torch.utils import profiling

        rec = profiling.records()
    except (ImportError, AttributeError):
        return None
    if not n or not rec["spans"] or "decode.replay" not in rec["counts"]:
        return None
    return rec["counts"]["decode.replay"] / n
