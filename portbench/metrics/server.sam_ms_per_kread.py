"""Host ms a thousand reads that the server's worker spends writing SAM
text (`srv.sam`, `Bt2Server._align_pack`: `sam_record`, the END READ
markers, the join and the encode); the reads are those of the packs
(`srv.pack`'s count), over the packs whose spans started and ended in the
traced slice."""
from portbench.spans import named, pack_ms_per_kread, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return pack_ms_per_kread(named(TRACE, ctx, "srv.pack", "srv.sam"),
                             "srv.sam")
