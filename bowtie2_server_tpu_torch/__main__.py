"""Command line of the port (ref: the bowtie2/bowtie2-build/bowtie2-inspect
wrappers, bt2_search.cpp's option surface, bt2_dp.cpp and the
bowtie2-server client/server pair).

Usage:
  python -m bowtie2_server_tpu_torch build <ref.fa> <index_base>
         [--bt2 [-o offrate] [-t ftabchars]]
  python -m bowtie2_server_tpu_torch align (-x <index_base> | --ref-string S)
         (-U <reads> | -1 <m1> -2 <m2> | --interleaved <reads> | -c <csv>
          | --tab5/--tab6 <reads>) [-S out.sam] [OPTIONS]
         [--device cuda | --device cpu | --cpu]
  python -m bowtie2_server_tpu_torch align -x <index> --server-host H
         --server-port P (-U <reads.fq> | -1 <m1.fq> -2 <m2.fq>) [-S out.sam]
  python -m bowtie2_server_tpu_torch dp [problems.tsv] [--local]
         [--device cuda | --device cpu | --cpu]
  python -m bowtie2_server_tpu_torch inspect <index_base> [-n | -s]
  python -m bowtie2_server_tpu_torch server -x <index_base> [--port 8080]
         [--host 0.0.0.0] [--local] [--preset P] [--batch 4096]
         [--workers N] [--remote-worker HOST:PORT ...] [--device cuda | --cpu]
  python -m bowtie2_server_tpu_torch client [--host H] [--port P] -x <index>
         (-U <reads.fq> | -1 <m1.fq> -2 <m2.fq>) [-S out.sam] [--passthrough]

`align` takes every option string of `python -m bowtie2_server_tpu align`
(`align --help` lists them) and writes the same SAM records, `--un/--al`
files, BAM records, `--met` TSV counters and alignment summary with the same
options; an option string is a real option, an accepted no-op (its help says
why) or a documented reject ("is not supported: <reason>"). `dp` scores
`read<TAB>ref` problems (the lines `--dp-log` and `--log-dp-opp` write) as
that CLI's `dp` does. `server`, `client`, `inspect` and `build --bt2` behave
as that CLI's. An index is either the port's `.fm.npz` or a `.bt2`/`.bt2l`
file set.

`align` and `dp` run on the card (`--device cuda`) unless the caller asks
for the CPU; there is no fallback: without a card, `--device cuda` fails.

The paired inputs other than -1/-2 (`-b --align-paired-reads`, paired
tab5/tab6, `--interleaved`) follow the JAX CLI's branches for them: they
take the orientation and fragment lengths, `--mapq-v`, `--log-dp-opp` and
the `--met` hooks, and ignore `--dovetail --no-contain --no-overlap`,
`--nofw/--norc`, `--no-unal`, `--un-conc/--al-conc` and the TSV's rows;
`--sample` applies to tab5/tab6 and `--interleaved`, not to BAM.

Where this CLI differs from the JAX one: the `--met` TSV's memory columns
(EbwtMemPeak, ResolveMemPeak) sum the port's own tensors (`DeviceFm` of
both directions on the device, the host SA), so they differ from the JAX
TSV's; its counter columns do not. (Two pair batches are in flight where
the JAX CLI aligns one at a time; the output is the same.)
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from collections import deque


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


def _tab6_is_paired(path) -> bool:
    """Peek whether a tab5/tab6 file carries mate-2 columns (tab5 = 5
    fields with a shared name, tab6 = 6 fields; ref: pat.h:843)."""
    try:
        from .io.fastq import _open_maybe_compressed
        with _open_maybe_compressed(path) as f:
            for line in f:
                if isinstance(line, str):
                    line = line.encode()
                line = line.rstrip(b"\r\n")
                if line:
                    return len(line.split(b"\t")) >= 5
    except OSError:
        pass
    return False


def scoring_policy(args):
    """(Scoring, SearchPolicy) of the preset, the scoring options and the
    search options, mapped as the JAX CLI maps them: scoring flags append
    policy tokens to the preset (ref: aligner_seed_policy.cpp:356-660)."""
    from dataclasses import replace

    from .align.pipeline import ALL_HITS, SearchPolicy
    from .utils.presets import apply_policy_string, preset_params
    from .utils.simple_func import SimpleFunc
    sc, polkw = preset_params(args.preset, args.local)
    toks = []
    if args.bwa_sw_like:
        # ref: bt2_search.cpp:1099-1110 ARG_BWA_SW_LIKE
        toks.append("MA=1;MMP=C3;RDG=5,2;RFG=5,2")
    if args.noisy_hpoly and args.rdg is None and args.rfg is None:
        # --454/--ion-torrent: homopolymer-tolerant gap penalties
        # (ref: noisyHpolymer -> *_BADHPOLY defaults, scoring.h:73-82)
        toks.append("RDG=3,1;RFG=3,1")
    if args.multiseed:
        ms = args.multiseed.split(",")
        if not 1 <= len(ms) <= 5:
            sys.exit("Error: expected 5 or fewer comma-separated "
                     f"arguments to --multiseed, got {len(ms)}")
        toks.append(f"SEED={ms[0]}")
        if len(ms) > 1:
            toks.append(f"SEEDLEN={ms[1]}")
        if len(ms) > 2:
            toks.append("IVAL=" + ",".join(ms[2:5]))
    if args.ma is not None:
        toks.append(f"MA={args.ma}")
    if args.mp is not None:
        toks.append(f"MMP=Q,{args.mp}" if "," in args.mp
                    else f"MMP=C{args.mp}")
    if args.np_pen is not None:
        toks.append(f"NP={args.np_pen}")
    if args.rdg is not None:
        toks.append(f"RDG={args.rdg}")
    if args.rfg is not None:
        toks.append(f"RFG={args.rfg}")
    if args.n_ceil is not None:
        toks.append(f"NCEIL={args.n_ceil}")
    if args.policy:
        toks.append(args.policy)
    if toks:
        sc, polkw = apply_policy_string(";".join(toks), sc, polkw)
    if args.ignore_quals:
        sc = sc.with_ignore_quals()
    if args.score_min:
        sc = replace(sc, score_min=SimpleFunc.parse(args.score_min))
    if args.gbar is not None:
        sc = replace(sc, gapbar=args.gbar)
    if args.bwa_sw_like:
        sc = replace(sc, bwa_sw_like=True)
    if args.fail_streak is not None:
        polkw["dp_streak"] = args.fail_streak
    if args.seed_boost is not None:
        polkw["boost_thresh"] = args.seed_boost
    if args.exact_upfront is not None:
        polkw["no_exact_upfront"] = not args.exact_upfront
    if args.mm1_upfront is not None:
        polkw["no_1mm_upfront"] = not args.mm1_upfront
    if args.seedlen:
        polkw["seed_len"] = args.seedlen
    if args.ival:
        polkw["interval"] = SimpleFunc.parse(args.ival)
    if args.rounds:
        polkw["n_seed_rounds"] = args.rounds
    if args.dpad is not None:
        polkw["maxhalf"] = args.dpad
    # -a: unbounded reporting (ref: ReportingParams::allHits); -M samples 1
    # of the best among > M alignments, and -k/-a turn it off (ref:
    # bt2_search.cpp:1246-1311)
    khits = ALL_HITS if args.all_hits else args.khits
    if args.mhits is not None:
        polkw["mhits"], polkw["msample"] = args.mhits, True
        khits = 1
    elif args.khits > 1 or args.all_hits:
        polkw["mhits"], polkw["msample"] = 0, False
    if args.seed_mms:
        polkw["n_seed_mms"] = args.seed_mms
    if args.non_deterministic:
        polkw["non_deterministic"] = True
    return sc, SearchPolicy(khits=khits, seed=args.seed, **polkw)


def _check_align_args(args):
    """Argument rules of the reference (bt2_search.cpp) and the inputs
    align needs."""
    if args.preserve_tags and not args.bam:
        # ref: bt2_search.cpp:1675-1677
        sys.exit("Error: --preserve-tags can only be used when aligning "
                 "BAM reads.")
    # the *-local preset aliases and --bwa-sw-like imply --local (ref:
    # ARG_PRESET_*_LOCAL cases fall through localAlign = true)
    if args.preset_local:
        args.preset = args.preset_local
        args.local = True
    if args.bwa_sw_like:
        args.local = True
    if args.sc_unmapped_tlen and not args.local:
        # ref: bt2_search.cpp:1664-1667
        sys.exit("ERROR: --soft-clipped-unmapped-tlen can only be set "
                 "for local alignments.")
    if args.trim_to is not None and (args.trim5 or args.trim3):
        # ref: bt2_search.cpp:1226 "--trim-to and --trim3/--trim5"
        sys.exit("Error: --trim-to and --trim3/--trim5 are mutually "
                 "exclusive")
    paired = args.m1 is not None or args.m2 is not None
    unpaired = (args.U is not None or args.cmdline_reads is not None
                or args.interleaved is not None
                or isinstance(args.tab_reads, str))
    if (args.index is None and not args.ref_string) or unpaired == paired \
            or (paired and None in (args.m1, args.m2)):
        sys.exit("Error: align needs -x <index_base> (or --ref-string) and "
                 "either -U <reads> or -1 <m1.fq> -2 <m2.fq>")


def _parse_trim_to(v):
    """--trim-to [3:|5:]N -> (end, N) (ref: bt2_search.cpp:1219)."""
    side = 3
    if ":" in v:
        s_, v = v.split(":", 1)
        if s_ not in ("3", "5"):
            sys.exit("Error: --trim-to end must be 3 or 5")
        side = int(s_)
    n_tt = int(v)
    if n_tt < 0:
        sys.exit("Error: --trim-to length must be at least 0")
    return side, n_tt


def _open_out(path, comp):
    """--un/--al [-gz|-bz2] output (ref: the wrapper's compressed demux,
    bowtie2-server:489-626)."""
    if comp == "gz":
        import gzip
        return gzip.open(path, "wt")
    if comp == "bz2":
        import bz2
        return bz2.open(path, "wt")
    return open(path, "w")


def _pick(plain, gz, bz2_):
    if gz:
        return gz, "gz"
    if bz2_:
        return bz2_, "bz2"
    return plain, ""


def _write_fq(f, rec):
    # --un/--al write reads in their ORIGINAL orientation (the reference
    # echoes the input read, not the aligned-strand SEQ)
    seq = rec.orig_seq or rec.seq
    qual = rec.orig_qual or rec.qual
    f.write(f"@{rec.name}\n{seq.decode()}\n+\n"
            f"{qual.decode() or 'I'*len(seq)}\n")


def _sample_keep(b, frac, seed):
    """--sample: keep a read iff LCG(ROTL(per-read content seed, 2))'s first
    float < frac (ref: bt2_search.cpp:3219-3222; pairs sample on mate 1's
    seed, as the reference's read_a().seed)."""
    import numpy as np

    from .utils.rng import RandomSource, gen_rand_seeds_batch
    seeds = gen_rand_seeds_batch(
        b.seqs, b.lens, np.clip(b.quals + 33, 33, 255),
        [nm.encode() if isinstance(nm, str) else nm for nm in b.names], seed)
    keep = []
    for i, s in enumerate(seeds):
        s = int(s)
        r = RandomSource(((s << 2) | (s >> 30)) & 0xFFFFFFFF)
        if r.next_float() < frac:
            keep.append(i)
    return keep


def _index_nbytes(up_al) -> int:
    """Bytes of the aligner's FM tensors on its device, both directions
    (the --met TSV's EbwtMemPeak analog)."""
    devs = [up_al.dev] + ([up_al.dev_mirror]
                          if up_al.dev_mirror is not None else [])
    return int(sum(getattr(x, "nbytes", 0) for d in devs for x in d))


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
    _check_align_args(args)
    if args.cpu:
        args.device = "cpu"
    from .index.bt2_reader import detect_index
    from .io.fastq import iter_fastq, make_qual_conv, prefetch
    from .io.metrics import AlnSummary, PerfMetrics
    from .io.sam import (parse_sam_opt_config, passthrough_line, sam_header,
                         sam_record)
    from .utils import trace

    if args.ref_string:
        # --ref-string: a throwaway index of the given sequence (ref:
        # bowtie2-server wrapper:430-443)
        from .index.build import build_index
        idx = build_index(f">ref_string\n{args.ref_string}\n")
    else:
        _, loader = detect_index(args.index)
        idx = loader(args.index)
    sc, pol = scoring_policy(args)
    # input quality encoding (ref: qual.h:105 charToPhred33)
    qual_conv = make_qual_conv(phred64=args.phred64, solexa=args.solexa,
                               int_quals=args.int_quals)
    sample_on = args.sample is not None and args.sample < 1.0

    # --refidx: numeric RNAMEs; --fullref: keep whitespace in names (the
    # default truncates at the first whitespace; ref: ARG_REFIDX/FULLREF)
    if args.refidx:
        disp_names = [str(i) for i in range(len(idx.ref_names))]
    elif args.fullref:
        disp_names = list(idx.ref_names)
    else:
        disp_names = [n.split()[0] if n.split() else n
                      for n in idx.ref_names]
    hdr_text = sam_header(disp_names, idx.ref_lens, " ".join(sys.argv),
                          rg_id=args.rg_id, rg_fields=args.rg,
                          no_head=args.sam_no_head, no_sq=args.sam_no_sq)
    bam_w = None
    if args.output_bam:
        # BAM output (the wrapper delegates it to `samtools view -b`,
        # bowtie2-server:495-505; encoded in process here)
        from .io.bam import BamWriter
        raw = open(args.S, "wb") if args.S else sys.stdout.buffer
        bam_w = BamWriter(raw, hdr_text, disp_names, idx.ref_lens)
        out = raw
    else:
        out = open(args.S, "w") if args.S else sys.stdout
        out.write(hdr_text)

    un_path, un_comp = _pick(args.un, args.un_gz, args.un_bz2)
    al_path, al_comp = _pick(args.al, args.al_gz, args.al_bz2)
    un_f = _open_out(un_path, un_comp) if un_path else None
    al_f = _open_out(al_path, al_comp) if al_path else None
    summ = AlnSummary()
    met_fh = open(args.met_file, "w") if args.met_file else sys.stderr
    # --met-stderr/--met-file emit the reference's 129-column PerfMetrics
    # TSV at the --met cadence (ref: bt2_search.cpp:1923); --met-read
    # emits one line a batch
    ticker = PerfMetrics(interval=args.met, out=met_fh,
                         per_read=args.met_per_read) \
        if (args.met_stderr or args.met_file or args.met_per_read) else None
    opened = []   # log files the aligners write, closed at the end

    def wire(up_al, strands=True):
        """Attach the options' hooks to an UnpairedAligner (the paired
        aligner's `up` too): MAPQ version, QC filter, --nofw/--norc (where
        `strands`), the live --met sources (DP-shape columns, traceback
        counters, memory analogs)."""
        up_al.mapq_v = args.mapq_v
        up_al.qc_filter = args.qc_filter
        if strands:
            up_al.nofw, up_al.norc = args.nofw, args.norc
        if not ticker:
            return
        up_al.want_met = True
        ticker.live_bt = up_al.bt_ctr
        ticker.mem_index = _index_nbytes(up_al)
        sa = getattr(up_al.idx.fw, "sa", None)
        ticker.mem_resolve = int(sa.nbytes) if sa is not None else 0

    def log_file(path):
        f = open(path, "w")
        opened.append(f)
        return f

    t0 = time.time()
    # -t reads its stage times from the recorder's spans
    tracing = args.timing and not trace.enabled()
    if tracing:
        trace.enable(capacity=1 << 20)
    trim_to = (_parse_trim_to(args.trim_to) if args.trim_to is not None
               else None)
    fq_kw = dict(batch_size=args.batch, trim5=args.trim5, trim3=args.trim3,
                 skip=args.skip, upto=args.upto, trim_to=trim_to)
    # what only the FASTQ reader keeps
    fastq_kw = dict(fq_kw, keep_comment=args.sam_append_comment,
                    keep_orig=args.passthrough,
                    qname_trunc=not args.sam_no_qname_trunc,
                    qual_conv=qual_conv)
    opt_flags = (parse_sam_opt_config(args.sam_opt_config)
                 if args.sam_opt_config else None)
    sam_kw = dict(xeq=args.xeq, append_comment=args.sam_append_comment,
                  show_rand_seed=args.show_rand_seed,
                  omit_sec_seq=args.omit_sec_seq, opt_flags=opt_flags)

    def write_rec(rec):
        line = sam_record(rec, disp_names, args.rg_id, **sam_kw)
        if bam_w is not None:
            bam_w.write_sam_line(line)
            return
        out.write(line + "\n")
        if args.passthrough:
            # the original read record follows each SAM record (ref:
            # aln_sink.cpp:2142-2146; the wrapper demuxes on these)
            out.write(passthrough_line(rec) + "\n")

    al = None
    tab_src = (args.tab_reads if isinstance(args.tab_reads, str)
               else args.U)
    pair_src = None
    # the paired options beyond orientation and fragment lengths apply to
    # -1/-2 only, as in the JAX CLI's branches (module doc)
    all_pair_opts = bool(args.m1 and args.m2)
    if args.bam and args.align_paired_reads:
        # paired records in a BAM align as pairs (ref: pat.h:1074
        # BAMPatternSource, gAlignPairedBAM)
        from .io.bam import iter_bam_paired
        pair_src = iter_bam_paired(args.U, batch_size=args.batch)
        sample_on = False
        all_pair_opts = False
    elif args.m1 and args.m2:
        pair_src = zip(prefetch(iter_fastq(args.m1, **fastq_kw)),
                       prefetch(iter_fastq(args.m2, **fastq_kw)))
    elif args.tab_reads and _tab6_is_paired(tab_src):
        # paired tab5/tab6 rows align as pairs (ref: pat.h:843
        # TabbedPatternSource with mate-2 fields)
        from .io.fastq import iter_tab_file
        pair_src = iter_tab_file(tab_src, batch_size=args.batch,
                                 qual_conv=qual_conv)
    elif args.interleaved:
        from .io.fastq import iter_interleaved
        pair_src = iter_interleaved(args.interleaved, batch_size=args.batch,
                                    qual_conv=qual_conv)
    if pair_src is not None:
        n = _align_paired(args, idx, sc, pol, pair_src, wire, log_file,
                          write_rec, summ, ticker, sample_on, all_pair_opts)
    else:
        from .align.pipeline import UnpairedAligner
        from .io.fastq import (iter_cmdline_reads, iter_fasta_reads,
                               iter_raw_reads, iter_tab_file)
        if args.bam:
            from .io.bam import iter_bam
            reads_iter = iter_bam(args.U, batch_size=args.batch,
                                  preserve_tags=args.preserve_tags)
        elif args.cmdline_reads:
            reads_iter = iter_cmdline_reads(
                args.cmdline_reads, batch_size=args.batch, trim5=args.trim5,
                trim3=args.trim3, trim_to=trim_to)
        elif args.fasta_reads:
            reads_iter = iter_fasta_reads(args.U, **fq_kw)
        elif args.qseq_reads:
            from .io.fastq import iter_qseq
            reads_iter = iter_qseq(args.U, **fq_kw)
        elif args.fasta_cont:
            from .io.fastq import iter_fasta_continuous
            kv = dict(p.split(":", 1) for p in args.fasta_cont.split(","))
            reads_iter = iter_fasta_continuous(
                args.U, length=int(kv["k"]), freq=int(kv.get("i", 1)),
                batch_size=args.batch)
        elif args.raw_reads:
            reads_iter = iter_raw_reads(
                args.U, batch_size=args.batch, trim5=args.trim5,
                trim3=args.trim3, trim_to=trim_to)
        elif args.tab_reads:
            reads_iter = (b for b, _ in iter_tab_file(
                tab_src, batch_size=args.batch, qual_conv=qual_conv))
        else:
            reads_iter = iter_fastq(args.U, **fastq_kw)
        if sample_on:
            from .io.fastq import subset_batch
            reads_iter = (subset_batch(b, _sample_keep(b, args.sample,
                                                       args.seed))
                          for b in reads_iter)
        al = UnpairedAligner(idx, scoring=sc, policy=pol, device=args.device)
        wire(al)
        if args.dp_log:
            al.dp_log = log_file(args.dp_log)
        use_native = not (args.passthrough or args.xeq
                          or args.sam_append_comment or args.show_rand_seed
                          or args.omit_sec_seq or opt_flags
                          or un_f or al_f or bam_w is not None
                          or args.preserve_tags)
        n = _align_unpaired(al, prefetch(reads_iter), out, write_rec, summ,
                            ticker, disp_names, args, use_native, un_f, al_f)
    dt = time.time() - t0
    if args.timing:
        # ref: timer.h Timer blocks gated by -t/--time; the unpaired
        # aligner's stages only, as the JAX CLI prints them
        if al is not None:
            for k, v in _stage_times(trace.spans(t0)).items():
                print(f"Time {k}: {v:.2f}s", file=sys.stderr)
        print(f"Overall time: {dt:.2f}s", file=sys.stderr)
    if tracing:
        trace.disable()
    if not args.quiet:
        summ.print_summary(sys.stderr)
    print(f"# {n} reads in {dt:.1f}s = {n/max(dt,1e-9):.0f} reads/s "
          f"on {args.device}", file=sys.stderr)
    for f in [un_f, al_f] + opened:
        if f:
            f.close()
    if args.met_file:
        met_fh.close()
    if bam_w is not None:
        bam_w.close()
    if args.S:
        out.close()


# -t's stages: the recorder's span (utils/trace.py) and its label. The
# fetch is the wall from the fetch call until a batch's output is on the
# host: the card's remaining time plus the copy, not the enqueue; it
# counts the refetches of a capacity escalation too
STAGES = {"cg.fetch": "device_fetch", "up.rect": "dp"}


def _stage_times(spans) -> dict:
    """{label: seconds} of -t's stages over `spans`, in the order the
    stages first ended."""
    out: dict = {}
    for sp in spans:
        if sp.name in STAGES:
            k = STAGES[sp.name]
            out[k] = out.get(k, 0.0) + sp.s
    return out


def _align_unpaired(al, batches, out, write_rec, summ, ticker, disp_names,
                    args, use_native, un_f, al_f):
    """Unpaired batches through the UnpairedAligner, three in flight;
    fast-path batches go through the native SAM writer where the options
    allow it; under -k/-a each read's secondary records follow its primary.
    Returns the reads aligned."""
    from .io.sam import sam_format_batch_native

    def batch_results():
        # dispatch device work for the next batches before finishing the
        # current one (ref: async readahead + worker overlap, pat.h:1558)
        inflight = deque()
        for batch in batches:
            inflight.append(al.align_async(batch))
            if len(inflight) >= 3:
                yield al.align_wait(inflight.popleft())
        while inflight:
            yield al.align_wait(inflight.popleft())

    n = 0
    out_b = getattr(out, "buffer", None)
    for recs in batch_results():
        blob = None
        if use_native and getattr(recs, "soa", None) is not None:
            blob = sam_format_batch_native(recs, disp_names, args.rg_id,
                                           no_unal=args.no_unal)
        if blob is not None:
            if out_b is not None:
                out.flush()
                out_b.write(blob)
            else:
                out.write(blob.decode())
            na = summ.add_unpaired_soa(recs)
            n += len(recs)
            if ticker:
                nb = sum(len(s) for s in recs.batch.raw_seq)
                ticker.add_batch(len(recs), nb, len(recs), nb, False,
                                 al_uni=na, **recs.metrics)
            continue
        for r in recs:
            if not (args.no_unal and not r.aligned):
                write_rec(r)
            if not r.secondary:
                summ.add_unpaired(r)
                if un_f and not r.aligned:
                    _write_fq(un_f, r)
                if al_f and r.aligned:
                    _write_fq(al_f, r)
        prim = [r for r in recs if not r.secondary]
        n += len(prim)
        if ticker:
            nb = sum(len(r.orig_seq) for r in prim)
            ticker.add_batch(len(prim), nb, len(prim), nb, False,
                             al_uni=sum(r.aligned for r in prim),
                             **getattr(recs, "metrics", {}))
    return n


def _align_paired(args, idx, sc, pol, pair_src, wire, log_file, write_rec,
                  summ, ticker, sample_on, all_opts):
    """Pair batches through the PairedAligner, two in flight; both records
    of a pair are written in turn. With `all_opts` (-1/-2) the paired
    options apply: --dovetail --no-contain --no-overlap, --nofw/--norc,
    --no-unal, --un-conc/--al-conc routing pairs by concordance (ref:
    bowtie2-server wrapper:489-626) and a TSV row a batch; without, as in
    the JAX CLI's other paired branches, none of them does. Returns the
    reads aligned."""
    from .align.paired import PairedAligner, PairedPolicy
    from .io.fastq import subset_batch
    pe_kw = (dict(dovetail_ok=args.dovetail, contain_ok=not args.no_contain,
                  olap_ok=not args.no_overlap) if all_opts else {})
    pe = PairedPolicy(pol=args.orient, minfrag=args.minins,
                      maxfrag=args.maxins, **pe_kw)
    pal = PairedAligner(idx, scoring=sc, policy=pol, pe=pe,
                        device=args.device, no_mixed=args.no_mixed,
                        no_discordant=args.no_discordant,
                        sc_unmapped_tlen=args.sc_unmapped_tlen)
    wire(pal.up, strands=all_opts)
    if args.dp_log_opp:
        pal.dp_log_opp = log_file(args.dp_log_opp)
    no_unal = args.no_unal and all_opts
    unc_f, alc_f = [], []
    if all_opts:
        unc_path, unc_comp = _pick(args.un_conc, args.un_conc_gz,
                                   args.un_conc_bz2)
        alc_path, alc_comp = _pick(args.al_conc, args.al_conc_gz,
                                   args.al_conc_bz2)
        unc_f = [_open_out(unc_path.replace("%", str(m)), unc_comp)
                 for m in (1, 2)] if unc_path else []
        alc_f = [_open_out(alc_path.replace("%", str(m)), alc_comp)
                 for m in (1, 2)] if alc_path else []

    def pair_results():
        inflight = deque()
        for b1, b2 in pair_src:
            if sample_on:
                keep = _sample_keep(b1, args.sample, args.seed)
                b1, b2 = subset_batch(b1, keep), subset_batch(b2, keep)
            inflight.append((b1, b2, pal.align_async(b1, b2)))
            if len(inflight) >= 2:
                b1, b2, h = inflight.popleft()
                yield b1, b2, pal.align_wait(h)
        while inflight:
            b1, b2, h = inflight.popleft()
            yield b1, b2, pal.align_wait(h)

    n = 0
    for b1, b2, pairs in pair_results():
        for r1, r2 in pairs:
            if not (no_unal and not r1.aligned and not r2.aligned):
                write_rec(r1)
                write_rec(r2)
            summ.add_pair(r1, r2)
            if unc_f and not r1.proper:
                _write_fq(unc_f[0], r1)
                _write_fq(unc_f[1], r2)
            if alc_f and r1.proper:
                _write_fq(alc_f[0], r1)
                _write_fq(alc_f[1], r2)
        n += 2 * len(pairs)
        if ticker and all_opts:
            nb = sum(len(s) for s in (b1.raw_seq + b2.raw_seq))
            ticker.add_batch(2 * len(pairs), nb, 2 * len(pairs), nb, True,
                             con_uni=sum(1 for p1, _ in pairs if p1.proper),
                             dis=sum(1 for p1, _ in pairs if p1.yt == "DP"),
                             **pal.last_metrics)
    for fl in unc_f + alc_f:
        fl.close()
    return n


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


def cmd_dp(args):
    """Standalone DP problem solver (ref: bt2_dp.cpp, fed by --dp-log):
    reads `read_seq<TAB>ref_seq` problems from a file or stdin, scores them
    with the rectangle DP on the device (the CUDA kernel of ops/csrc/sw.cu
    on the card), traces back on the host, and prints score, end cell,
    start, CIGAR and MD a line."""
    import numpy as np

    from .align.edits import cigar_md_stats, traceback
    from .ops.sw import SwConfig, sw_align_batch
    from .utils import dna

    device = "cpu" if args.cpu else args.device
    cfg = SwConfig(ma=2, local=True) if args.local else SwConfig()
    src = open(args.input) if args.input != "-" else sys.stdin
    rows = []
    for line in src:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rd_s, ref_s = line.split("\t")[:2]
        rows.append((dna.encode(rd_s), dna.encode(ref_s)))
    if src is not sys.stdin:
        src.close()
    if not rows:
        return
    lq = max(len(r) for r, _ in rows)
    lc = max(len(f) for _, f in rows)
    B = len(rows)
    rd = np.full((B, lq), 5, np.uint8)
    ref = np.full((B, lc), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    reflens = np.zeros(B, np.int32)
    for i, (r, f) in enumerate(rows):
        rd[i, :len(r)] = r
        ref[i, :len(f)] = f
        lens[i] = len(r)
        reflens[i] = len(f)
    mm = np.full((B, lq), 6, np.int32)
    best, bi, bj = sw_align_batch(rd, lens, mm, ref, reflens, cfg,
                                  device=device)
    start = "?"   # a failed traceback prints the last start, as the JAX dp
    for i in range(B):
        r, f = rows[i]
        try:
            edits, start, rs = traceback(r, mm[i, :len(r)], f, cfg,
                                         int(bi[i]), int(bj[i]))
            st = cigar_md_stats(len(r), edits, rs, int(bi[i]) + 1)
            cig, md = st["cigar"], st["md"]
        except Exception:
            cig = md = "?"
        print(f"{int(best[i])}\t{int(bi[i])}\t{int(bj[i])}\t{start}\t"
              f"{cig}\t{md}")


_VERSION = "bowtie2_server_tpu_torch 0.1.0 (capabilities of bowtie2-server " \
           "2.5.4)"


class _ArgDesc(argparse.Action):
    def __call__(self, parser, ns, values, option_string=None):
        # name\t0|1 per option (ref: bt2_search.cpp:750 printArgDesc)
        for act in parser._actions:
            takes = 0 if act.nargs in (0, None) and isinstance(
                act, (argparse._StoreTrueAction, argparse._StoreFalseAction,
                      argparse._HelpAction, argparse._VersionAction,
                      _ArgDesc)) else 1
            for opt in act.option_strings:
                print(f"{opt.lstrip('-')}\t{takes}")
        parser.exit(0)


class _Reject(argparse.Action):
    def __call__(self, parser, ns, values, option_string=None):
        parser.error(f"{option_string} is not supported: {self.help}")


# accepted no-ops: structural in this design; each names the reference knob
# it would map to
_NOOP_FLAGS = (
    ("--ungapped", "ungapped extension is certified on the device for "
     "every candidate already"),
    ("--no-ungapped", "DP scores ungapped alignments identically"),
    ("--sse8", "int32 lanes on the device replace SSE u8"),
    ("--no-sse8", "int32 lanes on the device replace SSE i16"),
    ("--cache", "batch dedup replaces the seed cache"),
    ("--no-cache", "batch dedup replaces the seed cache"),
    ("--mm", "the index is device-resident, shared across batches"),
    ("--shmem", "the index is device-resident"),
    ("--filepar", "input is batch-pipelined"),
    ("--tri", "the banded kernel needs no checkpoint triangles"),
    ("--read-times", "per-batch timing rides -t"),
    ("--scan-narrowed", "SA resolution is exhaustive, not lazy"),
    ("--sanity", "differential tests replace in-process checks"),
    ("--verbose", "diagnostics go to stderr already"),
    ("--startverbose", "diagnostics go to stderr already"),
    ("--mapq-extra", "MAPQ inputs ride --mapq-print-inputs"),
    ("--no-extend", "seed hits are always DP-extended in batch"),
)
_NOOP_VALUED = (
    ("--cachelim", "batch dedup replaces the seed cache"),
    ("--cachesz", "batch dedup replaces the seed cache"),
    ("--local-seed-cache-sz", "batch dedup replaces the cache"),
    ("--seed-cache-sz", "batch dedup replaces the cache"),
    ("--cp-min", "the banded kernel stores O(L*K), no checkpoints"),
    ("--cp-ival", "the banded kernel stores O(L*K)"),
    ("--ee-fail-streak", "exact sweep is one fused batch op"),
    ("--ug-fail-streak", "ungapped certification is free on the device"),
    ("--dp-fails", "DP runs batched, -D caps the retry loop"),
    ("--ug-fails", "ungapped certification is free on the device"),
    ("--extends", "extension is one batched DP"),
    ("--tighten", "ReportingState tightening is structural"),
    ("-O", "parsed but unused by the reference too "
     "(multiseedOff, bt2_search.cpp:224)"),
    ("--seed-off", "parsed but unused by the reference too"),
    ("--thread-ceiling", "batching replaces thread elasticity"),
    ("--thread-piddir", "batching replaces thread elasticity"),
)
# documented rejects (no silent accepts): each errors with its reason
_REJECTS = (
    ("--bowtie2p5", "the deprecated 2.5 descent engine "
     "(aligner_seed2.cpp) is out of scope; use the default "
     "multiseed engine"),
    ("--desc-kb", "2.5 descent engine knob (see --bowtie2p5)"),
    ("--desc-landing", "2.5 descent engine knob"),
    ("--desc-exp", "2.5 descent engine knob"),
    ("--desc-prioritize", "2.5 descent engine knob"),
    ("--desc-fmops", "2.5 descent engine knob"),
    ("--test-25", "2.5 descent engine knob"),
    ("--sra-acc", "SRA input needs the NCBI SRA toolkit, which "
     "is optional in the reference too (USE_SRA)"),
    ("--hadoopout", "legacy Hadoop streaming output"),
    ("--partition", "legacy partitioned output"),
    ("--snpphred", "legacy SNP-aware colorspace option"),
    ("--snpfrac", "legacy SNP-aware colorspace option"),
    ("--orig", "legacy sanity-check option"),
    ("--pause", "debugger aid"),
    ("--mmsweep", "mmap page-sweep; the index is device-resident"),
    ("--seed-summ", "per-seed summary debug dump"),
    ("--seed-summary", "per-seed summary debug dump"),
    ("--overhang", "reference-overhanging alignments are "
     "filtered, as in the reference default"),
    ("-Q", "bowtie1-era FASTA+quals input; provide FASTQ instead"),
    ("--quals", "bowtie1-era FASTA+quals input; provide FASTQ"),
    ("--Q1", "bowtie1-era FASTA+quals input; provide FASTQ"),
    ("--Q2", "bowtie1-era FASTA+quals input; provide FASTQ"),
)


def _add_align_parser(sub):
    pa = sub.add_parser("align", allow_abbrev=False)
    add = pa.add_argument
    # ---- inputs and outputs ----
    add("-x", "--index", dest="index", default=None)
    add("--ref-string", dest="ref_string", default=None,
        help="align against this sequence (a throwaway index)")
    add("-U", "--unpaired", dest="U", default=None)
    add("-1", dest="m1", default=None)
    add("-2", dest="m2", default=None)
    add("-S", "--output", dest="S", default=None)
    add("--device", default="cuda",
        help="torch device the pipeline runs on (default cuda)")
    add("--cpu", action="store_true", help="the same as --device cpu")
    add("--batch", "--reads-per-batch", type=int, default=2048)
    add("-f", dest="fasta_reads", action="store_true",
        help="reads are FASTA")
    add("--qseq", dest="qseq_reads", action="store_true",
        help="reads are Illumina qseq (ref: read_qseq.cpp)")
    add("-F", dest="fasta_cont", default=None,
        help="k:<len>,i:<ivl> FASTA-continuous windows (ref: pat.h:956)")
    add("--qc-filter", dest="qc_filter", action="store_true",
        help="drop reads whose qseq filter flag is 0")
    add("-r", dest="raw_reads", action="store_true",
        help="reads are raw one-per-line")
    add("-c", dest="cmdline_reads", default=None,
        help="comma-separated reads on the command line")
    add("--tab5", "--tab6", "--12", dest="tab_reads", nargs="?", const=True,
        default=None,
        help="reads are tab5/tab6; with a value, that file is the input "
        "(ref: ARG_TAB5/ARG_TAB6/ARG_ONETWO)")
    add("-q", dest="fastq_reads", action="store_true",
        help="reads are FASTQ (the default)")
    add("--interleaved", default=None, help="interleaved paired FASTQ file")
    add("-b", "--bam", action="store_true", help="reads are in BAM format")
    add("--output-bam", dest="output_bam", action="store_true",
        help="write BAM instead of SAM (the wrapper's --bam, encoded in "
        "process instead of via samtools)")
    add("--align-paired-reads", dest="align_paired_reads",
        action="store_true",
        help="align paired BAM records as pairs (ref: pat.h:1074)")
    add("--preserve-tags", dest="preserve_tags", action="store_true",
        help="BAM input: pass the original records' optional tags through "
        "to the output (ref: bt2_search.cpp:736, sam.cpp:881 "
        "printPreservedOptFlags)")
    add("--phred33", "--phred33-quals", action="store_true",
        help="input qualities are Phred+33 (default)")
    add("--phred64", "--phred64-quals", "--solexa1.3-quals", dest="phred64",
        action="store_true", help="input qualities are Phred+64 "
        "(ref: qual.h:125)")
    add("--solexa-quals", dest="solexa", action="store_true",
        help="input qualities are Solexa log-odds +64 "
        "(ref: qual.h:113, qual.cpp:57 solToPhred)")
    add("--int-quals", "--integer-quals", dest="int_quals",
        action="store_true", help="input qualities are space-separated "
        "integers (ref: qual.h:156 intToPhred33)")
    add("-5", "--trim5", dest="trim5", type=int, default=0)
    add("-3", "--trim3", dest="trim3", type=int, default=0)
    add("--trim-to", dest="trim_to", default=None,
        help="[3:|5:]N — trim reads longer than N to N bases from the "
        "given end (default 3'); mutually exclusive with -3/-5 "
        "(ref: bt2_search.cpp:1219 ARG_TRIM_TO)")
    add("-s", "--skip", dest="skip", type=int, default=0)
    add("-u", "--upto", "--qupto", dest="upto", type=int, default=None)
    add("--sample", type=float, default=None,
        help="align only this random fraction of reads, chosen by the "
        "per-read content seed (ref: sampleFrac, bt2_search.cpp:3219)")
    # ---- alignment mode, presets, scoring ----
    # --local / --end-to-end share one dest: the last one wins, as in the
    # reference (bt2_search.cpp:1415/1419)
    add("--local", dest="local", action="store_const", const=True,
        default=False)
    add("--end-to-end", dest="local", action="store_const", const=False,
        help="end-to-end alignment mode (the default; last of "
        "--local/--end-to-end wins; ref: ARG_END_TO_END)")
    add("--preset", default=None,
        help="very-fast|fast|sensitive|very-sensitive[-local]")
    for name in ("very-fast", "fast", "sensitive", "very-sensitive"):
        add(f"--{name}", dest="preset", action="store_const", const=name)
    for name in ("very-fast", "fast", "sensitive", "very-sensitive"):
        add(f"--{name}-local", dest="preset_local", action="store_const",
            const=name)
    add("--ignore-quals", dest="ignore_quals", action="store_true")
    add("--score-min", "--min-score", dest="score_min", default=None)
    add("--ma", type=int, default=None,
        help="match bonus (ref: MA policy token)")
    add("--mp", default=None, help="MX[,MN] max/min mismatch penalty "
        "(ref: MMP)")
    add("--np", dest="np_pen", type=int, default=None,
        help="penalty for N in read or reference (ref: NP)")
    add("--rdg", default=None,
        help="read gap open,extend penalties (ref: RDG)")
    add("--rfg", default=None,
        help="ref gap open,extend penalties (ref: RFG)")
    add("--n-ceil", dest="n_ceil", default=None,
        help="max Ns function, e.g. L,0,0.15 (ref: NCEIL)")
    add("--gbar", type=int, default=None,
        help="disallow gaps within this many bases of the read ends "
        "(default 4; ref: scoring.h gapbar)")
    add("--policy", default=None,
        help="raw ';'-separated policy string (ref: aligner_seed_policy.cpp)")
    add("--454", "--ion-torrent", dest="noisy_hpoly", action="store_true",
        help="homopolymer-tolerant gap penalties RDG=3,1 RFG=3,1 "
        "(ref: noisyHpolymer, scoring.h:73-82)")
    add("--bwa-sw-like", dest="bwa_sw_like", action="store_true",
        help="BWA-SW-like scoring: local with MA=1, MMP=C3, RDG=5,2, "
        "RFG=5,2, MIN=C,1 (ref: bwaSwLike, bt2_search.cpp:1421-1432)")
    add("--mapq-v", dest="mapq_v", type=int, default=2, choices=(1, 2, 3),
        help="MAPQ calculation version (ref: unique.h:509 new_mapq; "
        "default 2)")
    # ---- search ----
    add("-k", "--khits", dest="khits", type=int, default=1)
    add("-a", "--all", dest="all_hits", action="store_true")
    add("-M", dest="mhits", type=int, default=None,
        help="sample 1 best alignment when > M exist "
        "(ref: bt2_search.cpp:1246)")
    add("-N", "--seedmms", dest="seed_mms", type=int, default=0,
        choices=(0, 1), help="mismatches allowed inside a seed "
        "(ref: searchSeedBi, aligner_seed.cpp:668)")
    add("-L", "--seedlen", dest="seedlen", type=int, default=None)
    add("-i", "--seedival", dest="ival", default=None)
    add("-R", "--seed-rounds", dest="rounds", type=int, default=None)
    add("--multiseed", default=None,
        help="mms,len,ival[,extra] — set -N, -L and -i in one flag "
        "(ref: ARG_MULTISEED_IVAL -> SEED/IVAL policy tokens)")
    add("--dpad", type=int, default=None,
        help="DP padding: max gap excursion per side (default 15; widens "
        "the banded kernel's band: 16-31 give K = 128, 32-255 the wide-band "
        "kernel; ref: bt2_search.cpp maxhalf/--dpad)")
    add("-D", "--fail-streak", dest="fail_streak", type=int, default=None,
        help="consecutive failed extend attempts before giving up on a "
        "read (ref: maxDpStreak/-D, bt2_search.cpp:1740)")
    add("--dp-fail-streak", dest="fail_streak", type=int,
        help="alias of -D for the DP streak (ref: ARG_DP_FAIL_STREAK_THRESH)")
    add("--seed-boost", dest="seed_boost", type=int, default=None,
        help="reseed when avg hits per nonzero seed >= this (default 300; "
        "ref: seedBoostThresh)")
    add("--exact-upfront", dest="exact_upfront", action="store_true",
        default=None, help="do the up-front exact sweep (default on)")
    add("--no-exact-upfront", dest="exact_upfront", action="store_false",
        help="skip the up-front exact full-read sweep "
        "(ref: doExactUpFront, bt2_search.cpp:3454)")
    add("--1mm-upfront", dest="mm1_upfront", action="store_true",
        default=None, help="do the up-front 1-mismatch search (default on)")
    add("--no-1mm-upfront", dest="mm1_upfront", action="store_false",
        help="skip the up-front 1-mismatch end-to-end search "
        "(ref: do1mmUpFront, bt2_search.cpp:3634)")
    add("--1mm-minlen", type=int, default=60,
        help="accepted for compatibility (parsed but unused by the "
        "reference too: do1mmMinLen is set at bt2_search.cpp:1438 and "
        "never consulted)")
    add("--nofw", action="store_true")
    add("--norc", action="store_true")
    add("--seed", type=int, default=0,
        help="global seed mixed into per-read tie-break RNG "
        "(ref: genRandSeed, pat.cpp:51)")
    add("--non-deterministic", "--nondeterministic",
        dest="non_deterministic", action="store_true",
        help="seed per-read RNG from wall clock instead of read content "
        "(ref: bt2_search.cpp:3215)")
    # ---- paired ----
    add("-I", "--minins", dest="minins", type=int, default=0)
    add("-X", "--maxins", dest="maxins", type=int, default=500)
    add("--fr", dest="orient", action="store_const", const="FR",
        default="FR")
    add("--rf", dest="orient", action="store_const", const="RF")
    add("--ff", dest="orient", action="store_const", const="FF")
    add("--no-mixed", dest="no_mixed", action="store_true")
    add("--no-discordant", dest="no_discordant", action="store_true")
    add("--dovetail", action="store_true")
    add("--no-dovetail", dest="dovetail", action="store_false",
        help="dovetailing pairs are not concordant (default)")
    add("--no-contain", dest="no_contain", action="store_true")
    add("--contain", dest="no_contain", action="store_false",
        help="a mate containing the other is concordant (default)")
    add("--no-overlap", dest="no_overlap", action="store_true")
    add("--overlap", dest="no_overlap", action="store_false",
        help="overlapping mates are concordant (default)")
    add("--soft-clipped-unmapped-tlen", dest="sc_unmapped_tlen",
        action="store_true",
        help="local mode: exclude soft-clipped bases from TLEN "
        "(ref: bt2_search.cpp:731 ARG_SC_UNMAPPED_TLEN)")
    # ---- --un/--al ----
    add("--un", default=None)
    add("--al", default=None)
    add("--un-gz", dest="un_gz", default=None,
        help="like --un, gzip-compressed (ref: wrapper demux)")
    add("--un-bz2", dest="un_bz2", default=None)
    add("--al-gz", dest="al_gz", default=None)
    add("--al-bz2", dest="al_bz2", default=None)
    add("--un-conc", dest="un_conc", default=None,
        help="write non-concordant pairs to files (use %% for the mate "
        "number)")
    add("--al-conc", dest="al_conc", default=None,
        help="write concordant pairs to files")
    add("--un-conc-gz", dest="un_conc_gz", default=None)
    add("--un-conc-bz2", dest="un_conc_bz2", default=None)
    add("--al-conc-gz", dest="al_conc_gz", default=None)
    add("--al-conc-bz2", dest="al_conc_bz2", default=None)
    # ---- SAM ----
    add("--no-unal", dest="no_unal", action="store_true")
    add("--rg-id", "--sam-rg-id", dest="rg_id", default=None)
    add("--rg", "--sam-rg", "--sam-RG", "--RG", action="append", default=[])
    add("--refidx", action="store_true",
        help="print reference index (0-based ordinal) instead of the "
        "reference name in SAM (ref: ARG_REFIDX)")
    add("--fullref", action="store_true",
        help="print the whole reference name including whitespace "
        "(default: truncate at first whitespace; ref: ARG_FULLREF)")
    add("--sam-no-head", "--sam-nohead", "--sam-noHD", "--sam-no-hd",
        "--no-head", "--no-hd", "--no-HD", dest="sam_no_head",
        action="store_true",
        help="suppress all SAM header lines (ref: ARG_SAM_NOHEAD)")
    add("--sam-no-sq", "--sam-nosq", "--sam-noSQ", "--no-sq", "--no-SQ",
        dest="sam_no_sq", action="store_true",
        help="suppress @SQ header lines (ref: ARG_SAM_NOSQ)")
    add("--omit-sec-seq", "--sam-omit-sec-seq", dest="omit_sec_seq",
        action="store_true", help="print * for SEQ/QUAL of secondary "
        "alignments (ref: ARG_SAM_OMIT_SEC_SEQ)")
    add("--sam-opt-config", dest="sam_opt_config", default=None,
        help="comma-separated optional-tag toggles, 'tag' enables and "
        "'-tag' disables, e.g. '-md,-xs' (ref: sam.h:162 "
        "toggleOptFlagByName)")
    add("--passthrough", action="store_true",
        help="emit the %%-escaped original read record after each SAM "
        "record (ref: ARG_READ_PASSTHRU)")
    add("--xeq", action="store_true",
        help="use =/X instead of M in CIGAR (ref: ARG_XEQ)")
    add("--sam-append-comment", dest="sam_append_comment",
        action="store_true", help="append FASTQ comment to the SAM record "
        "(ref: ARG_SAM_APPEND_COMMENT)")
    add("--sam-no-qname-trunc", dest="sam_no_qname_trunc",
        action="store_true", help="keep whole read names incl. whitespace "
        "(ref: samTruncQname)")
    add("--show-rand-seed", dest="show_rand_seed", action="store_true",
        help="emit ZS:i per-read random seed (ref: ARG_SHOW_RAND_SEED)")
    # ---- metrics, logs, timing ----
    add("--met-stderr", "--metrics-stderr", dest="met_stderr",
        action="store_true")
    add("--met-file", "--metrics-file", dest="met_file", default=None)
    add("--met", "--metrics", type=float, default=1.0)
    add("--met-read", "--metrics-per-read", dest="met_per_read",
        action="store_true")
    add("--quiet", action="store_true")
    add("-t", "--time", dest="timing", action="store_true",
        help="print stage wall-clock times")
    add("--dp-log", "--log-dp", dest="dp_log", default=None,
        help="log DP problems (replayable with the dp subcommand)")
    add("--log-dp-opp", dest="dp_log_opp", default=None,
        help="log opposite-mate (rescue) DP problems to FILE "
        "(ref: bt2_search.cpp:730 ARG_LOG_DP_OPP)")
    add("-p", "--threads", type=int, default=1,
        help="accepted for compatibility (batching replaces thread-level "
        "parallelism)")
    add("--reorder", action="store_true",
        help="accepted for compatibility (output is always in input order)")
    add("--wrapper", default=None,
        help="accepted for compatibility; the Perl wrapper passes "
        "--wrapper basic-0 (ref: bt2_search.cpp:749)")
    add("--mapq-print-inputs", "--mapq-extra-inputs", action="store_true",
        help="accepted for compatibility; no-op: the reference's YI:Z "
        "writer is commented out (unique.h:383-390), so the flag changes "
        "nothing observable there either")
    # ---- client drop-in ----
    add("--server-host", dest="srv_host", default=None,
        help="client drop-in: align via a running server "
        "(ref: opts.h:166; env BT2CLT_SERVER_HOST)")
    add("--server-port", dest="srv_port", type=int, default=None,
        help="client drop-in: align via a running server "
        "(ref: opts.h:167; env BT2CLT_SERVER_PORT)")
    add("--version", action="version", version=_VERSION)
    add("--usage", action="help", help="print usage (ref: --usage)")
    add("--arg-desc", nargs=0, action=_ArgDesc,
        help="print option names and arg arity, then exit "
        "(ref: bt2_search.cpp:750)")
    for flag, why in _NOOP_FLAGS:
        add(flag, action="store_true",
            help=f"accepted for compatibility; no-op: {why}")
    for flag, why in _NOOP_VALUED:
        add(flag, default=None,
            help=f"accepted for compatibility; no-op: {why}")
    for flag, why in _REJECTS:
        add(flag, nargs="?", action=_Reject, help=why, metavar="")
    pa.set_defaults(fn=cmd_align)


def make_parser():
    p = argparse.ArgumentParser(prog="bowtie2_server_tpu_torch",
                                allow_abbrev=False)
    p.add_argument("--version", action="version", version=_VERSION)
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

    _add_align_parser(sub)

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
                    "(default cuda: every card of the node, see "
                    "--workers)")
    ps.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ps.add_argument("--batch", type=int, default=4096)
    ps.add_argument("--workers", dest="n_workers", type=int, default=1,
                    help="device groups serving packs, one worker each "
                    "(round-robin dispatch across connections; ref: the "
                    "shared worker pool, pat.cpp:2016-2086): the cards "
                    "split into N groups of cards // N; a group of "
                    "several cards is a 'dp' mesh that shards each pack's "
                    "reads over its cards, the index on every card (the "
                    "default 1 on a node of several cards: one mesh over "
                    "all of them); cards left over are named idle. One "
                    "host thread enqueues a mesh's shards in turn, so on "
                    "a host-bound path a mesh is not faster than one card "
                    "(four H100 80GB HBM3 at 700 W: 0.74x one card's "
                    "reads/s; PERF.md)")
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

    pd = sub.add_parser("dp", allow_abbrev=False)
    pd.add_argument("input", nargs="?", default="-")
    pd.add_argument("--local", action="store_true")
    pd.add_argument("--device", default="cuda",
                    help="torch device the DP runs on (default cuda)")
    pd.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    pd.set_defaults(fn=cmd_dp)
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
