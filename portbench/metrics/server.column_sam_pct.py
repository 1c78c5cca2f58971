"""The share (%) of the packs' reads (a mate one) whose SAM line the
server's worker wrote from the aligners' column stores with the native
emitter (`srv.sam`'s `columns` over its `mates`, `Bt2Server._align_pack`),
over the packs whose `srv.sam` spans started and ended in the traced
slice; the rest are rendered a record at a time by `sam_record`. A
program whose `srv.sam` spans carry no counts reads nothing."""
from portbench.spans import named, recorder, share_pct

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return share_pct([s for s in named(TRACE, ctx, "srv.sam")
                      if "mates" in s.attrs], "columns", "mates")
