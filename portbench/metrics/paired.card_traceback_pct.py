"""The share (%) of the paired decisions' traceback passes that the CUDA
traceback kernel ran (`pe.decide`'s `tb_card` over its `tb`, `align/
paired.py`: the held traces `_hold_traces` batched before the decisions,
of the --met Bt counter's increase over them), over the `pe.decide` spans
that lie inside a `pe.wait` span (on its thread) that started and ended in
the traced slice. None where the spans carry no such counts or count no
traceback."""
from portbench.spans import named, recorder, share_pct

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    spans = named(TRACE, ctx, "pe.wait", "pe.decide")
    waits = [s for s in spans if s.name == "pe.wait"]
    dec = [s for s in spans if s.name == "pe.decide" and "tb_card" in s.attrs
           and any(w.thread == s.thread and w.t0 <= s.t0 and s.t1 <= w.t1
                   for w in waits)]
    return share_pct(dec, "tb_card", "tb")
