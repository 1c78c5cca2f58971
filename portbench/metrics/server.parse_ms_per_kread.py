"""Host ms a thousand reads that the server's event loop spends parsing
tab6 lines into rows (`srv.parse`: `Bt2Server._handle_align`'s `parse`,
each stretch between two packs handed to the dispatcher), over the spans
that started and ended in the traced slice."""
from portbench.spans import ms_per_kread, named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return ms_per_kread(named(TRACE, ctx, "srv.parse"))
