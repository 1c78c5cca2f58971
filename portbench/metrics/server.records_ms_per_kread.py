"""Host ms a thousand reads that the server's worker spends taking the
AlnRecs out of the aligners' lazy results (`srv.records`, `_row_records`:
`LazyRecs.__getitem__`, `FastSoA.fill` and its MD strings); the reads are
those of the packs (`srv.pack`'s count), over the packs whose spans started
and ended in the traced slice."""
from portbench.spans import named, pack_ms_per_kread, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return pack_ms_per_kread(named(TRACE, ctx, "srv.pack", "srv.records"),
                             "srv.records")
