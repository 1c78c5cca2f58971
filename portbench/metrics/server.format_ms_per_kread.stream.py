"""Host ms a thousand reads that the server's worker spends in its packs
outside the aligners: batch building, `sam_record` formatting and the END
READ markers (`Bt2Server._align_pack` less the aligners' `align_batch`
calls inside it), over the packs that started and ended in the traced
slice."""
from portbench.probes import batch_reads, ended, inside, outermost, pack_reads

PROBES = {"pack": "server._align_pack", "up": "worker.up.align_batch",
          "pal": "worker.pal.align_batch"}
CAPTURE = {"pack": pack_reads, "up": batch_reads, "pal": batch_reads}


def read(calls, ctx):
    packs = ended(calls["pack"], ctx)
    reads = sum(c.info for c in packs)
    if not reads:
        return None
    aligns = inside(outermost(calls["up"] + calls["pal"]), packs)
    other = sum(c.s for c in packs) - sum(c.s for c in aligns)
    return other * 1e3 / (reads / 1e3)
