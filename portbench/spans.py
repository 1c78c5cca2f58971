"""The port's own spans (`bowtie2_server_tpu_torch/utils/trace.py`) for
the readers of its program_span metrics.

A reader calls `recorder()` when it is loaded, which turns the recorder
on: the traced run loads its readers after the warm-up and before the
clients start, and a --trace 0 run loads none, so it runs with the
recorder off. A program without the recorder gives no spans: `recorder()`
returns None, and the reader reads nothing.
"""
from __future__ import annotations


def recorder():
    """The port's recorder, turned on; None where the program has none."""
    try:
        from bowtie2_server_tpu_torch.utils import trace
    except ImportError:
        return None
    trace.enable()
    return trace


def named(trace, ctx, *names) -> list:
    """The spans of `names` that started and ended in the traced slice."""
    if trace is None:
        return []
    return [s for s in trace.spans(ctx.t_start, ctx.t_stop)
            if s.name in names]


def ms_per_kread(spans):
    """Their seconds as ms a thousand of the reads they count."""
    reads = sum(s.attrs["reads"] for s in spans)
    if not reads:
        return None
    return sum(s.s for s in spans) * 1e3 / (reads / 1e3)


def pack_ms_per_kread(spans, name: str):
    """The seconds of the `name` spans as ms a thousand reads of their
    packs (each pack's `srv.pack` span counts them), over the packs whose
    spans of both lie in `spans`."""
    reads = {s.pack: s.attrs["reads"] for s in spans if s.name == "srv.pack"}
    own = [s for s in spans if s.name == name and s.pack in reads]
    n = sum(reads[s.pack] for s in own)
    if not n:
        return None
    return sum(s.s for s in own) * 1e3 / (n / 1e3)


def mean_ms(spans):
    if not spans:
        return None
    return sum(s.s for s in spans) * 1e3 / len(spans)


def share_pct(spans, num: str, den: str):
    """100 x the sum of attribute `num` over that of `den`."""
    d = sum(s.attrs[den] for s in spans)
    if not d:
        return None
    return 100.0 * sum(s.attrs[num] for s in spans) / d
