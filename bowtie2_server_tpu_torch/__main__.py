"""Command line of the port (ref: the bowtie2/bowtie2-build/bowtie2-inspect
wrappers and the bowtie2-server client/server pair).

Usage:
  python -m bowtie2_server_tpu_torch build <ref.fa> <index_base>
         [--bt2 [-o offrate] [-t ftabchars]]
  python -m bowtie2_server_tpu_torch align -x <index_base> -U <reads.fq>
         [-S out.sam] [--end-to-end | --local] [--seed N] [SEARCH]
         [--device cuda]
  python -m bowtie2_server_tpu_torch align -x <index_base> -1 <m1.fq>
         -2 <m2.fq> [-S out.sam] [-I minins] [-X maxins] [--fr | --rf | --ff]
         [--no-mixed] [--no-discordant] [--end-to-end | --local] [--seed N]
         [SEARCH] [--device cuda]
  SEARCH: [-N 0|1] [-L seedlen] [-i func] [-k N | -a] [--no-1mm-upfront]
          [--no-exact-upfront]
  python -m bowtie2_server_tpu_torch align -x <index> --server-host H
         --server-port P (-U <reads.fq> | -1 <m1.fq> -2 <m2.fq>) [-S out.sam]
  python -m bowtie2_server_tpu_torch inspect <index_base> [-n | -s]
  python -m bowtie2_server_tpu_torch server -x <index_base> [--port 8080]
         [--host 0.0.0.0] [--local] [--preset P] [--batch 4096]
         [--workers N] [--remote-worker HOST:PORT ...] [--device cuda | --cpu]
  python -m bowtie2_server_tpu_torch client [--host H] [--port P] -x <index>
         (-U <reads.fq> | -1 <m1.fq> -2 <m2.fq>) [-S out.sam] [--passthrough]

`align` writes the same SAM records and alignment summary as
`python -m bowtie2_server_tpu align` with the same options, and `server`,
`client`, `inspect` and `build --bt2` behave as that CLI's. An index is
either the port's `.fm.npz` or a `.bt2`/`.bt2l` file set. Every other
option and subcommand of that CLI is refused: they are ROADMAP Queue A
item 14.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from collections import deque

_BATCH = 2048   # reads per batch, the reference CLI's --batch default
_REFUSED = ("not supported by the PyTorch port yet (ROADMAP Queue A item "
            "14: the rest of the CLI)")


def cmd_build(args):
    t0 = time.time()
    if args.bt2:
        # interchange format, byte-identical to bowtie2-build defaults
        # (ref: bt2_io.cpp:801 writeFromMemory; tests/test_torch_bt2.py)
        from .index.bt2_writer import write_bt2_from_fasta
        write_bt2_from_fasta(args.ref, args.base, off_rate=args.offrate,
                             ftab_chars=args.ftabchars)
        print(f"built .bt2 index {args.base} in {time.time()-t0:.1f}s",
              file=sys.stderr)
        return
    from .index.build import build_index
    idx = build_index(args.ref)
    idx.save(args.base)
    print(f"built index {args.base} ({idx.n} bp, {idx.n_refs} refs) "
          f"in {time.time()-t0:.1f}s", file=sys.stderr)


def search_policy(args):
    """(Scoring, SearchPolicy) of the preset and the search options, mapped
    as the JAX CLI maps them."""
    from .align.pipeline import ALL_HITS, SearchPolicy
    from .utils.presets import preset_params
    from .utils.simple_func import SimpleFunc
    sc, polkw = preset_params(None, args.local)
    if args.exact_upfront is not None:
        polkw["no_exact_upfront"] = not args.exact_upfront
    if args.mm1_upfront is not None:
        polkw["no_1mm_upfront"] = not args.mm1_upfront
    if args.seedlen:
        polkw["seed_len"] = args.seedlen
    if args.ival:
        polkw["interval"] = SimpleFunc.parse(args.ival)
    # -a: unbounded reporting (ref: ReportingParams::allHits); -k/-a turn
    # the -M sampling off (ref: bt2_search.cpp:1246-1311)
    khits = ALL_HITS if args.all_hits else args.khits
    if args.khits > 1 or args.all_hits:
        polkw["mhits"], polkw["msample"] = 0, False
    if args.seed_mms:
        polkw["n_seed_mms"] = args.seed_mms
    return sc, SearchPolicy(khits=khits, seed=args.seed, **polkw)


def cmd_align(args):
    if args.srv_port is not None or args.srv_host is not None:
        # drop-in client mode: the reference client binary takes
        # --server-host/--server-port on its align command line
        # (ref: bt2_search.cpp:677-679, env vars :526-536)
        args.host = args.srv_host or os.environ.get(
            "BT2CLT_SERVER_HOST", "localhost")
        args.port = args.srv_port or int(os.environ.get(
            "BT2CLT_SERVER_PORT", "8080"))
        args.index = str(args.index).rsplit("/", 1)[-1]
        return cmd_client(args)
    from .index.bt2_reader import detect_index
    from .io.metrics import AlnSummary
    from .io.sam import sam_header

    paired = args.m1 is not None or args.m2 is not None
    if args.index is None or (args.U is None) == (not paired) or \
            (paired and None in (args.m1, args.m2)):
        sys.exit("Error: align needs -x <index_base> and either -U "
                 "<reads.fq> or -1 <m1.fq> -2 <m2.fq>")
    _, loader = detect_index(args.index)
    idx = loader(args.index)
    sc, pol = search_policy(args)
    names = [n.split()[0] if n.split() else n for n in idx.ref_names]
    out = open(args.S, "w") if args.S else sys.stdout
    out.write(sam_header(names, idx.ref_lens, " ".join(sys.argv)))
    summ = AlnSummary()
    t0 = time.time()
    if paired:
        n, dev = _align_paired(args, idx, sc, pol, names, out, summ)
    else:
        n, dev = _align_unpaired(args, idx, sc, pol, names, out, summ)
    dt = time.time() - t0
    summ.print_summary(sys.stderr)
    print(f"# {n} reads in {dt:.1f}s = {n/max(dt,1e-9):.0f} reads/s "
          f"on {dev}", file=sys.stderr)
    if args.S:
        out.close()


def _align_paired(args, idx, sc, pol, names, out, summ):
    """-1/-2: pairs of FASTQ batches through the PairedAligner, two pair
    batches in flight; both records of a pair are written in turn (ref:
    the paired FASTQ branch of the JAX CLI). Returns (reads, device)."""
    from .align.paired import PairedAligner, PairedPolicy
    from .io.fastq import iter_fastq, prefetch
    from .io.sam import sam_record

    pe = PairedPolicy(pol=args.orient, minfrag=args.minins,
                      maxfrag=args.maxins)
    pal = PairedAligner(idx, scoring=sc, policy=pol, pe=pe,
                        device=args.device, no_mixed=args.no_mixed,
                        no_discordant=args.no_discordant)
    it1 = prefetch(iter_fastq(args.m1, batch_size=_BATCH))
    it2 = prefetch(iter_fastq(args.m2, batch_size=_BATCH))
    n = 0

    def emit(pairs):
        for r1, r2 in pairs:
            out.write(sam_record(r1, names) + "\n")
            out.write(sam_record(r2, names) + "\n")
            summ.add_pair(r1, r2)
        return 2 * len(pairs)

    inflight = deque()
    for b1, b2 in zip(it1, it2):
        inflight.append(pal.align_async(b1, b2))
        if len(inflight) >= 2:
            n += emit(pal.align_wait(inflight.popleft()))
    while inflight:
        n += emit(pal.align_wait(inflight.popleft()))
    return n, pal.up.device


def _align_unpaired(args, idx, sc, pol, names, out, summ):
    """-U: batches through the UnpairedAligner, three in flight; fast-path
    batches are formatted by the native SAM writer; under -k/-a each read's
    secondary records follow its primary. Returns (reads, device)."""
    from .align.pipeline import UnpairedAligner
    from .io.fastq import iter_fastq, prefetch
    from .io.sam import sam_format_batch_native, sam_record

    al = UnpairedAligner(idx, scoring=sc, policy=pol, device=args.device)

    def batch_results():
        # dispatch device work for the next batches before finishing the
        # current one (ref: async readahead + worker overlap, pat.h:1558)
        inflight = deque()
        for batch in prefetch(iter_fastq(args.U, batch_size=_BATCH)):
            inflight.append(al.align_async(batch))
            if len(inflight) >= 3:
                yield al.align_wait(inflight.popleft())
        while inflight:
            yield al.align_wait(inflight.popleft())

    n = 0
    out_b = getattr(out, "buffer", None)
    for recs in batch_results():
        blob = (sam_format_batch_native(recs, names)
                if getattr(recs, "soa", None) is not None else None)
        if blob is not None:
            if out_b is not None:
                out.flush()
                out_b.write(blob)
            else:
                out.write(blob.decode())
            summ.add_unpaired_soa(recs)
            n += len(recs)
        else:
            for r in recs:
                out.write(sam_record(r, names) + "\n")
                if not r.secondary:
                    summ.add_unpaired(r)
                    n += 1
    return n, al.device


def cmd_inspect(args):
    """ref: bt2_inspect.cpp:255-330 — names, summary, or FASTA
    reconstruction. The index keeps the full reference (with Ns), so
    reconstruction is a direct dump rather than an LF-walk."""
    from .index.bt2_reader import detect_index
    from .utils import dna
    _, loader = detect_index(args.base)
    idx = loader(args.base)
    if args.names:
        for n in idx.ref_names:
            print(n)
        return
    if args.summary:
        print(f"Sequence-count\t{idx.n_refs}")
        for i, n in enumerate(idx.ref_names):
            print(f"Sequence-{i}\t{n}\t{int(idx.ref_lens[i])}")
        return
    for i, name in enumerate(idx.ref_names):
        s = int(idx.ref_full_start[i])
        seq = dna.decode(idx.ref_full[s : s + int(idx.ref_lens[i])])
        print(f">{name}")
        for j in range(0, len(seq), 60):
            print(seq[j : j + 60])


def cmd_server(args):
    from .server.bt2srv import run_server
    run_server(args.index, port=args.port, host=args.host, local=args.local,
               preset=args.preset, batch_size=args.batch,
               n_workers=args.n_workers,
               remote_workers=args.remote_workers or None,
               device="cpu" if args.cpu else args.device)


def cmd_client(args):
    from .io.fastq import iter_fastq
    from .server.client import Bt2Client
    passthrough = getattr(args, "passthrough", False)
    cl = Bt2Client(args.host, args.port, args.index,
                   passthrough=passthrough)
    keep = passthrough
    # the client substitutes %04X slot names on the wire and restores the
    # original names on receipt (ref: pat.h:2464-2550); callers pass raw
    # names
    if args.m1 and args.m2:
        def rows():
            for b1, b2 in zip(
                    iter_fastq(args.m1, batch_size=1024, keep_orig=keep),
                    iter_fastq(args.m2, batch_size=1024, keep_orig=keep)):
                for i in range(len(b1)):
                    r = (b1.names[i], b1.raw_seq[i], b1.raw_qual[i],
                         b2.names[i], b2.raw_seq[i], b2.raw_qual[i])
                    if keep and b1.origs is not None:
                        r = r + ((b1.origs[i], b2.origs[i]),)
                    yield r
    else:
        def rows():
            for b in iter_fastq(args.U, batch_size=1024, keep_orig=keep):
                for i in range(len(b)):
                    r = (b.names[i], b.raw_seq[i], b.raw_qual[i])
                    if keep and b.origs is not None:
                        r = r + (b.origs[i],)
                    yield r
    cl.send_reads(rows())
    out = open(args.S, "w") if args.S else sys.stdout
    n = 0
    for line in cl.finish():
        out.write(line + "\n")
        n += 1
    print(f"received {n} SAM records", file=sys.stderr)
    if args.S:
        out.close()


def cmd_refused(args):
    sys.exit(f"Error: {args.cmd}: {_REFUSED}")


def make_parser():
    p = argparse.ArgumentParser(prog="bowtie2_server_tpu_torch",
                                allow_abbrev=False)
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("build", allow_abbrev=False)
    pb.add_argument("ref")
    pb.add_argument("base")
    pb.add_argument("-o", "--offrate", type=int, default=4,
                    help="SA sampling exponent for --bt2 output "
                    "(ref: bowtie2-build -o)")
    pb.add_argument("-t", "--ftabchars", type=int, default=10,
                    help="ftab k-mer length for --bt2 output "
                    "(ref: bowtie2-build -t)")
    pb.add_argument("--bt2", action="store_true",
                    help="emit the reference .bt2 six-file format "
                    "(byte-identical to bowtie2-build defaults) instead "
                    "of the native .fm.npz")
    pb.set_defaults(fn=cmd_build)

    pa = sub.add_parser("align", allow_abbrev=False)
    pa.add_argument("-x", "--index", dest="index", default=None)
    pa.add_argument("-U", "--unpaired", dest="U", default=None)
    pa.add_argument("-1", dest="m1", default=None)
    pa.add_argument("-2", dest="m2", default=None)
    pa.add_argument("-S", "--output", dest="S", default=None)
    # --local / --end-to-end share one dest: the last one wins, as in the
    # reference (bt2_search.cpp:1415/1419)
    pa.add_argument("--local", dest="local", action="store_const",
                    const=True, default=False)
    pa.add_argument("--end-to-end", dest="local", action="store_const",
                    const=False)
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("-I", "--minins", dest="minins", type=int, default=0)
    pa.add_argument("-X", "--maxins", dest="maxins", type=int, default=500)
    pa.add_argument("--fr", dest="orient", action="store_const",
                    const="FR", default="FR")
    pa.add_argument("--rf", dest="orient", action="store_const", const="RF")
    pa.add_argument("--ff", dest="orient", action="store_const", const="FF")
    pa.add_argument("--no-mixed", dest="no_mixed", action="store_true")
    pa.add_argument("--no-discordant", dest="no_discordant",
                    action="store_true")
    pa.add_argument("-N", "--seedmms", dest="seed_mms", type=int, default=0,
                    choices=(0, 1),
                    help="mismatches allowed inside a seed "
                    "(ref: searchSeedBi, aligner_seed.cpp:668)")
    pa.add_argument("-L", "--seedlen", dest="seedlen", type=int,
                    default=None)
    pa.add_argument("-i", "--seedival", dest="ival", default=None)
    pa.add_argument("-k", "--khits", dest="khits", type=int, default=1)
    pa.add_argument("-a", "--all", dest="all_hits", action="store_true")
    pa.add_argument("--no-exact-upfront", dest="exact_upfront",
                    action="store_false", default=None,
                    help="skip the up-front exact full-read sweep "
                    "(ref: doExactUpFront, bt2_search.cpp:3454)")
    pa.add_argument("--no-1mm-upfront", dest="mm1_upfront",
                    action="store_false", default=None,
                    help="skip the up-front 1-mismatch end-to-end search "
                    "(ref: do1mmUpFront, bt2_search.cpp:3634)")
    pa.add_argument("--device", default="cuda",
                    help="torch device the pipeline runs on (default cuda)")
    pa.add_argument("--server-host", dest="srv_host", default=None,
                    help="client drop-in: align via a running server "
                    "(ref: opts.h:166; env BT2CLT_SERVER_HOST)")
    pa.add_argument("--server-port", dest="srv_port", type=int, default=None,
                    help="client drop-in: align via a running server "
                    "(ref: opts.h:167; env BT2CLT_SERVER_PORT)")
    pa.set_defaults(fn=cmd_align)

    pi = sub.add_parser("inspect", allow_abbrev=False)
    pi.add_argument("base")
    pi.add_argument("-n", dest="names", action="store_true")
    pi.add_argument("-s", dest="summary", action="store_true")
    pi.set_defaults(fn=cmd_inspect)

    ps = sub.add_parser("server", allow_abbrev=False)
    ps.add_argument("-x", dest="index", required=True)
    ps.add_argument("--port", type=int, default=8080)
    ps.add_argument("--host", default="0.0.0.0")
    ps.add_argument("--local", action="store_true")
    ps.add_argument("--preset", default=None)
    ps.add_argument("--device", default="cuda",
                    help="torch device the packs are aligned on "
                    "(default cuda; with --workers N, one worker on each "
                    "of N cards)")
    ps.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ps.add_argument("--batch", type=int, default=4096)
    ps.add_argument("--workers", dest="n_workers", type=int, default=1,
                    help="devices serving packs, one worker each "
                    "(round-robin dispatch across connections; ref: the "
                    "shared worker pool, pat.cpp:2016-2086)")
    ps.add_argument("--remote-worker", dest="remote_workers",
                    action="append", default=[], metavar="HOST:PORT",
                    help="add a backend BT2SRV server (one per remote "
                    "host) to the worker pool; packs relay over the wire "
                    "protocol and merge in submission order (multi-host "
                    "scale-out, SURVEY §2.3 row 3)")
    ps.set_defaults(fn=cmd_server)

    pc = sub.add_parser("client", allow_abbrev=False)
    pc.add_argument("--host", "--server-host",
                    default=os.environ.get("BT2CLT_SERVER_HOST",
                                           "localhost"))
    pc.add_argument("--port", "--server-port", type=int,
                    default=int(os.environ.get("BT2CLT_SERVER_PORT",
                                               "8080")))
    pc.add_argument("-x", dest="index", default="index")
    pc.add_argument("-U", dest="U", default=None)
    pc.add_argument("-1", dest="m1", default=None)
    pc.add_argument("-2", dest="m2", default=None)
    pc.add_argument("-S", dest="S", default=None)
    pc.add_argument("--passthrough", action="store_true",
                    help="re-emit the original input record after each SAM "
                         "record (restored client-side from the slot map; "
                         "ref: pat.cpp:2286-2336)")
    pc.set_defaults(fn=cmd_client)

    # the JAX CLI's standalone DP solver is not ported yet
    pd = sub.add_parser("dp", allow_abbrev=False)
    pd.set_defaults(fn=cmd_refused)
    return p


def main(argv=None):
    args, extra = make_parser().parse_known_args(argv)
    if extra:
        sys.exit(f"Error: {' '.join(extra)}: {_REFUSED}")
    args.fn(args)


if __name__ == "__main__":
    main()
