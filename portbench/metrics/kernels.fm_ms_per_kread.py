"""Device ms a thousand enqueued reads in the FM walk kernels of the
general short-read shape (`ops/csrc/fm.cu`: `fm_walk_kernel`, RECORD,
SEARCH and CONT, and `fm_lf_step_kernel`), from torch.profiler's trace:
the launches that started inside the traced slice, on every card, over
the reads of the `cg.enqueue` spans that started and ended in it
(`reads`). Only the trace is read, so nothing adds a synchronisation.
Nothing is read without a trace, without an FM launch in the slice, or
where the enqueues carry no counts."""
from portbench.spans import named, recorder

TRACE = recorder()
PROBES = {}
KERNELS = ("fm_walk_kernel", "fm_lf_step_kernel")


def read(calls, ctx):
    tr = ctx.trace
    if tr is None:
        return None
    reads = sum(s.attrs["reads"] for s in named(TRACE, ctx, "cg.enqueue")
                if "reads" in s.attrs)
    lo = (tr.t_start - tr.origin) * 1e6
    hi = (tr.t_stop - tr.origin) * 1e6
    us = [b - a for nm, _, a, b in tr.events
          if any(k in nm for k in KERNELS) and lo <= a <= hi]
    if not reads or not us:
        return None
    return sum(us) / 1e3 / (reads / 1e3)
