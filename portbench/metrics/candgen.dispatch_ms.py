"""Mean host ms of one `CandGen.dispatch` (`align/candgen.py`): packing a
batch's reads and enqueueing the fused pipeline on one card, over the calls
that started in the traced slice."""
PROBES = {"d": "worker.up.candgen.dispatch"}


def read(calls, ctx):
    ds = calls["d"]
    if not ds:
        return None
    return sum(c.s for c in ds) * 1e3 / len(ds)
