#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100, sm_90a).

Run from the root of a checkout:  python3 chip_smoke.py [--paths]

(--paths: only phases 1, 2, 4, SR, BIG and PE, for an A/B of two
checkouts on one card; --opts: only phases 1, 2 and OPTS; --mesh: only
phases 1, 2 and MESH; --tb: only phases 1, 2 and TB.)

It imports nothing of JAX. Phases, in order; any failure exits non-zero and
prints no result line:
  1. environment: torch and CUDA versions, the card's name and power limit;
     fails without a CUDA device;
  2. build: nvcc builds the port's kernels from ops/csrc/ (registers and
     spills of each);
  3. kernels: each CUDA kernel against its plain torch version on the same
     CUDA tensors, at the shapes its path gives it (exact equality,
     tolerance 0: all values are int32), with the median device time of
     each under torch.profiler (bench_dp.device_ms; the CUDA-event time of
     a call, which also brackets the wrapper's host work, beside it) and
     its bound: the wide-band kernel at K = 128 (beside the register
     kernel at the same band), the ALU-ceiling probe (its rate is the
     int32 ceiling every bound divides by), the three banded kernels at the
     shapes of scripts/bench_banded.py (P = 33792, Lq = 128): the register
     kernel at K = 64 with 4 in 5 reads of 128 bases, K = 64 with every
     read 100 bases as on the main path, K = 32, K = 128; the wide-band
     kernel at K = 256 (both length mixes) and K = 512; the general kernel
     (the one for scores outside a byte, which the paths launch after the
     register kernel) at the first K = 64 shape under a scoring that sends
     every problem there; with the SASS instructions a cell of each one's
     row loop over gap rows, and all three on the edge tile of
     tests/torch_tiles.py at every band under every scoring of the tests;
     the rectangle kernel at the three shapes of
     scripts/bench_rect.py (P = 4096; the unpaired path's run-boundary
     candidates; the paired path's mate-rescue windows) and on the
     tie-heavy tile of tests/torch_tiles.py;
  TB. the traceback kernel (ops/csrc/sw_banded_tb.cu) against the numpy
     oracle banded_traceback on the problems of tests/torch_tiles.py
     (traceback_problems, K = 64, 100 bp reads, end cells from the fill
     kernel), with its device time (bench_dp.device_ms, median of 5) and
     bound at P = 64 end-to-end (a pack's gapped winners) and P = 4096
     --local (a pack whose every winner is traced);
  DP. the DP microbench (scripts/bench_dp.py of the port) at its reference
     shape and at the main path's banded shape: cells/s, the ALU ceiling
     its probe measures, roofline_frac, the SASS instruction mix of the
     probe's loop;
  4. the main path at full size: a 4 Mbp synthetic genome (a 3.6 Mbp
     chromosome plus 400 contigs of 1 kbp, the shape of a draft assembly,
     so the run-boundary rectangle DP runs in every batch) with the full
     k-mer seed table on the device; UnpairedAligner(device='cuda') over
     8 batches of 32768 reads of 100 bp (0-3 substitutions, half reverse
     complemented) at dispatch depth 4, as bench.py drives the reference
     package; then one --local batch of 8192 reads. Launch counters are
     zeroed just before and read just after; placement at the planted
     origin is checked; two more batches run under torch.profiler for the
     device busy share and the register banded kernel's, its general
     kernel's and the rect kernel's launches, device ms and share of device
     time;
  PE. the paired path at full width, the shape of bench_paired.py: a 12 Mbp
     genome (8 chromosomes of 1.5 Mbp) with the full k-mer seed table on
     the device; PairedAligner(device='cuda') over 150 bp FR pairs
     (fragment N(350, 40) clipped to [300, 600], 0-3 substitutions per
     mate, 2% of mates 2 with a substitution every 16 bases, so mate rescue
     runs in every batch), one warm-up batch of 16384 pairs and 4 measured
     at dispatch depth 2; both kernels must launch; placement of both mates
     at their planted origin and strand is checked; two more pair batches
     run under torch.profiler, as in phase 4;
  SRV. the BT2SRV server (server/bt2srv.py) on the card: Bt2Server(device=
     'cuda') on phase 4's genome and on phase PE's, each with the JAX
     server's pack size (4096 reads) on an event loop of its own thread
     (127.0.0.1, an ephemeral port); the packs run on the server's worker
     thread. One raw tab6 request with fixed names to each (2048 reads of
     18-100 bp, so packs take the fast and the general shape; 512 pairs)
     must equal, line by line, Bt2Server._align_pack of the same rows on
     CPU aligners; then 4 concurrent port clients of 16384 reads of 100 bp
     (the main path's workload) and 2 of 8192 pairs: every finish() must
     return, every read get one record and every pair two, with placement
     at the planted origin checked by the restored names. Prints reads/s
     and pairs/s (host clock, first send to last "All Done"), each
     server's first request apart, and the kernel launches of the phase;
     sw_banded must launch on the unpaired server and sw on the paired
     one. A failed pack fails the phase: nothing is answered from the CPU;
  MESH. the main path over a 'dp' mesh (parallel/mesh.py) at full width:
     phase 4's genome and reads (batches of 32768, e2e --sensitive, K = 64)
     on one card and on logical meshes of 2 and 4 shards on cuda:0, one
     warm-up batch and 4 measured at depth 4 each (launch counters zeroed
     just before and read just after): reads/s, the host ms a dispatch
     takes to enqueue its shards, sw_banded once a shard and dispatch (a
     shard that outgrew its capacities is named), two more batches under
     torch.profiler (busy share); every mesh's SAM equal line by line to
     the one-card run's. Then CUDA against CPU over a mesh of 2 logical
     shards (2048 reads, 2048 of 18-60 bp, 2048 under force_big, 512
     pairs with rescue), make_sharded_step on 4096 reads on the card
     against the CPU (best, offs, n_aligned equal; the one path that
     launches banded_kernel<32>), and dryrun_multichip and
     dryrun_full_pipeline over every card, or over 2 logical shards of
     cuda:0 on a one-card machine. With more than one card, the same loop
     over make_mesh() (every card) and a `--workers 1` Bt2Server, whose
     worker then holds that mesh: a raw request equal to a one-card
     worker's _align_pack and phase SRV's unpaired clients; with one card
     it logs that neither ran;
  SR. the short-read path at full width: the general shape (FM walks on
     the card) on phase 4's genome, its fw and mirror FM directions on the
     card (full SA, sides, ftab); 36 bp reads (0-2 substitutions, half
     reverse complemented, 1% with an N), one warm-up batch of 32768 and 4
     measured at depth 4, placement checked, two more under
     torch.profiler (device busy share, the FM kernels' shares); fm_walk,
     fm_lf_step and the banded kernel must launch;
  N1. one -N 1 batch of 32768 reads of 100 bp on the same genome, timed,
     placement checked;
  FM. fm_walk and fm_lf_step against their plain torch versions on the
     inputs the SR batch gave them (its recorded pass of 65536 lanes x 64
     steps, its ftab seed search, its 1-mismatch continuation and branch
     grid) and an ftab search over the -N 1 batch's seeds, each timed as
     in phase 3 against its bound and its
     dependent-chain floor (steps x the measured time of one dependent
     step), and exact on the FM edge tiles of tests/torch_tiles.py over
     both directions of the genome;
  BIG. the big-index path (docs/BIGINDEX.md: uint32 rows, the sampled SA
     resolved by walking left) forced on phase 4's genome
     (UnpairedAligner(force_big=True, device='cuda'), the layout built
     from the same index, no new index): 32768 reads of 100 bp, one
     warm-up batch (the inputs of its first walk-left and recorded pass
     captured) and 4 measured at depth 4, placement checked, the
     dispatches a batch (escalations to 2x, 4x, 16x; halvings), two more
     batches under torch.profiler (device busy share; fm_resolve's,
     fm_walk's and the banded kernel's device time); fm_resolve, fm_walk
     and the banded kernel must launch. Then fm_resolve against its plain
     torch version on the captured inputs and on an edge tile of rows (the
     first blocks' rows, marked ones among them, the primary row, row 0,
     the last row) over both directions, timed against its bound and its
     dependent-chain floor (scripts/bench_fm.py resolve_bound, the longest
     lane's steps x phase FM's dependent step), and the uint32 fm_walk
     against its plain version on the captured recorded pass;
  HBM. the FM kernels with their tables in HBM, far past the 50 MB L2: the
     gather probe (scripts/bench_fm.py gather_rates: random 32- and
     64-byte reads/s from a 2 GB table), then two directions laid out on
     the card by the layout's own rules (bench_fm.random_fm: a random BWT
     with its $ row, block counts, C array and ftab; marks at density
     1/16 with random samples), one of 2^30 rows for the int instantiation
     (512 MB of sides) and one of 2^31 + 2^20 rows for the uint32 one
     (1.07 GB of sides and 0.54 GB of marks, half its lanes' rows past
     2^31); on each, patterns read off the table by LF walks
     (bench_fm.walk_patterns, so every walk runs its full length) drive fm_walk's recorded pass
     (65536 lanes x 128), its seed search with and without the ftab
     (262144 x 22, some short, 1% with an N), its continuation (131072
     lanes from the record's ranges) and fm_lf_step (2^20 lanes), and on
     the uint32 one fm_resolve (196608 rows, a tenth invalid; chains that
     meet no mark within 16 trips among them), each bit-exact against its
     plain version and timed against its HBM bound (each distinct block
     one random read of its side at the probe's rate, two for the
     walk-left: side and mark row) and its chain floor (the
     longest lane's steps x one dependent step on the same table);
  5. CUDA against CPU, each through the port on both devices with identical
     output: one batch of 2048 reads (decoded batch results and SAM
     lines); 2048 reads of 18-60 bp and 2048 under -N 1 (the same); the
     host path: 256 reads under -k 2000 and under -a on a genome with a
     100 bp unit planted 300 times, and an index without its mirror
     direction (SAM lines); 512 pairs (SAM lines); one batch of 2048 reads
     at --dpad 32 (band K = 256) and one at --dpad 64 (K = 512), the paths
     on which the wide-band kernel must launch; under force_big, 2048 reads (decoded batch results and
     SAM lines; and the card's SAM equal to the small path's on the card)
     and 512 pairs (SAM lines);
  6. the entry point: `python -m bowtie2_server_tpu_torch align` on 10k reads
     (-U, and with -N 1 -L 20, and with -k 5) and on 5000 pairs (-1/-2)
     must write well-formed SAM;
  OPTS. the rest of the align command line and the dp subcommand, through
     the port's `__main__.main` in process (launch counters zeroed just
     before each run and read just after): `align --very-sensitive` on
     32768 reads of phase 4's workload at --batch 32768 and
     `--very-fast-local` on 8192 of them (the host traceback of every
     local winner bounds it, as phase 4's local batch): reads/s with index
     load, FASTQ parse and SAM write, placement at the planted origin, the
     banded and rect kernels' launches (a warm-up run of 1024 reads first
     builds each preset's k-mer table); then CUDA against CPU, every
     output with zero differing lines: `--dpad 32` and `--dpad 64` on 2048
     reads (sw_banded_wide must launch), `-b` on a BAM the port's BamWriter
     wrote, with `--preserve-tags --output-bam` (BAM compared after
     decoding), `-f --trim-to 3:80 --un --al`, `--tab6 --xeq --rg-id --rg`
     with `--met-file --met-read --dp-log -t` (the TSV's counter columns
     equal, its time and memory columns excluded), 1024 pairs on phase
     PE's genome under `--dovetail --no-contain --no-overlap --un-conc
     --al-conc`, and `dp` on the first 1024 logged problems (sw must
     launch).
The line before the last is a JSON object {"kernels": [...]}, with each
kernel's bound (bench_rect.bound: the larger of its int32 operations over
the probe's ceiling and its bytes over HBM3's 3.35 TB/s; a cell counts
bench_banded.banded_ops_per_cell operations in the banded kernels,
bench_rect.dp_ops_per_cell in the rect kernel; an LF step
bench_fm.OPS_PER_STEP and each input once; a walk-left trip
bench_fm.resolve_bound's count) and share of bound; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "tmp" / "chip_smoke"      # gitignored scratch of this script
READ_LEN = 100
BATCH = 32768
N_BATCHES = 8       # measured batches, after one warm-up batch
PROFILED = 2        # batches of each path run under torch.profiler, after
                    # the measured ones
DEPTH = 4           # batches in flight (bench.py's dispatch depth)
# --local traces every winner (on the card the traceback kernel, a numpy
# traceback a read in the CPU parity runs), so its one batch is a quarter
# of BATCH
LOCAL_BATCH = 8192
CHROM_LEN = 3_600_000
N_CONTIGS, CONTIG_LEN = 400, 1000
# Fractions of reads placed at their planted origin and strand. The port's
# own CPU run of this workload at small size (a 0.4 Mbp chromosome plus 40
# contigs, 12288 end-to-end reads, 2048 local reads) placed all of them
# (1.0000 both ways; local: start inside the read span); the limits leave
# room for reads whose substitutions make another placement score as well.
ORIGIN_MIN_E2E = 0.99
ORIGIN_MIN_LOCAL = 0.99
# the paired path (bench_paired.py's shape)
PAIR_LEN = 150
P_CHROMS, P_CHROM_LEN = 8, 1_500_000
PAIR_BATCH = 16384
PAIR_BATCHES = 4    # measured pair batches, after one warm-up batch
PAIR_DEPTH = 2      # pair batches in flight (bench_paired.py's depth)
SEEDLESS_FRAC = 0.02
# Fraction of pairs with both mates at their planted origin and strand.
# The port's own CPU run of this workload at small size (2 chromosomes of
# 1.5 Mbp, 3 x 2048 pairs) placed all of them (1.0000, all concordant); the
# limit leaves room for mates whose substitutions make another placement
# score as well.
PAIR_ORIGIN_MIN = 0.99
# --dpad values whose bands (K = 256, 512) the wide-band kernel serves
WIDE_MAXHALVES = (32, 64)
# the short-read path (the general shape: FM walks on the card): 36 bp
# reads with 0-2 substitutions on the main path's genome, --sensitive e2e
SR_LEN = 36
SR_BATCHES = 4      # measured batches, after one warm-up batch
N1_LEN = 100        # the -N 1 batch's reads (bench.py's)
# Fractions of reads placed at their planted origin and strand. The port's
# own CPU run of these workloads at small size (a 0.4 Mbp chromosome plus
# 40 contigs; 8192 reads of 36 bp, 2048 of 100 bp under -N 1) placed
# 0.8811 and 1.0000 of them, and no read elsewhere: a 36 bp read with two
# substitutions often breaks every seed and stays unaligned, as in the
# reference. The limits leave room for sampling.
ORIGIN_MIN_SR = 0.85
ORIGIN_MIN_N1 = 0.99
# the big-index path forced on the main path's genome: 100 bp reads as
# phase 4's, through the general shape
BIG_BATCHES = 4     # measured batches, after one warm-up batch
# Fraction of reads placed at their planted origin and strand. The port's
# own CPU run of this workload at small size (a 0.4 Mbp chromosome plus 40
# contigs, 3 x 2048 reads of 100 bp under force_big) placed all of them
# (1.0000), as the small path does (its SAM is the big path's); the limit
# leaves room for reads whose substitutions make another placement score
# as well.
ORIGIN_MIN_BIG = 0.99
# phase HBM: the FM kernels on tables far past the 50 MB L2, built on the
# card (scripts/bench_fm.py random_fm): an int-row direction of 2^30 rows
# (512 MB of sides) and a uint32 one of 2^31 + 2^20 rows (1.07 GB of sides
# and 0.54 GB of marks, rows past 2^31 walked); the big batch's shapes
HBM_TABLES = ((1 << 30, False), ((1 << 31) + (1 << 20), True))
HBM_RECORD = (65536, 128)     # lanes x steps of the recorded pass
HBM_SEEDS = (262144, 22)      # lanes x characters of the seed searches
HBM_CONT = 131072             # continuation lanes
HBM_RESOLVE = 196608          # walk-left lanes
# phase SRV: the BT2SRV server on the card, driven through its socket.
# Exactness: one raw tab6 request with fixed names to each server (reads of
# 18-100 bp; pairs), held line by line against _align_pack on CPU
# aligners. Load: concurrent port clients of phase 4's reads (the main
# path's workload) and of phase PE's pairs.
SRV_EXACT, SRV_EXACT_PAIRS = 2048, 512
SRV_CLIENTS, SRV_READS = 4, 16384
SRV_PAIR_CLIENTS, SRV_PAIRS = 2, 8192
# Fractions of reads (and of pairs, both mates) placed at their planted
# origin and strand: phases 4 and PE place all of them through the
# aligners (1.0000); the limits are theirs.
SRV_ORIGIN_MIN = ORIGIN_MIN_E2E
SRV_PAIR_ORIGIN_MIN = PAIR_ORIGIN_MIN
# the kernels device_shares reports, by a part of their names in the
# profiler: the register banded kernel, the general kernel launched after
# it in every call (it returns at once on the paths' scores), and the rect
# kernel (rect_warp_kernel; the one-thread kernel it replaced was
# rect_kernel)
SHARE_SYMBOLS = {"banded": "::banded_kernel<",
                 "banded_general": "::banded_general_kernel<",
                 "rect": "::rect_", "fm_walk": "fm_walk_kernel",
                 "fm_lf_step": "fm_lf_step_kernel",
                 "fm_resolve": "fm_resolve_kernel"}
# phase OPTS: the rest of the align command line through the port's CLI in
# process. Full width: --very-sensitive on BATCH reads of phase 4's
# workload at --batch BATCH, --very-fast-local on OPTS_LOCAL_READS at the
# same --batch: the host traceback of every local winner bounds it (BATCH
# reads took 104.3 s, 313.8 reads/s, on an H100 80GB HBM3 at 700 W), so it
# is cut as phase 4's local batch is; CUDA against CPU: OPTS_PARITY reads
# (the formats, outputs and --dpad runs), OPTS_PAIRS pairs, dp on the first
# OPTS_DP_PROBLEMS logged problems; the --met TSV compared without its time
# and memory columns
OPTS_LOCAL_READS = LOCAL_BATCH
OPTS_PARITY = 2048
OPTS_PAIRS = 1024
OPTS_DP_PROBLEMS = 1024
OPTS_NOT_COUNTERS = {"Time", "MemPeak", "EbwtMemPeak", "ResolveMemPeak"}
# phase MESH: the main path over a 'dp' mesh (parallel/mesh.py) at full
# width: logical meshes of MESH_SHARDS shards on cuda:0 beside the one-card
# path, one warm-up batch of BATCH reads and MESH_BATCHES measured (cut from
# N_BATCHES: the phase's time), PROFILED more under torch.profiler; CUDA
# against CPU over a mesh of 2 on MESH_PARITY reads (fast, 18-60 bp,
# force_big) and MESH_PAIRS pairs; make_sharded_step on MESH_STEP_READS
# reads of 100 bp
MESH_SHARDS = (2, 4)
MESH_CARD = "cuda:0"    # the card that holds the logical shards
MESH_BATCHES = 4
MESH_PARITY, MESH_PAIRS = 2048, 512
MESH_STEP_READS, MESH_STEP_K = 4096, 32
# kernels line: name -> (source in the port, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "sw_banded": ("sw_banded.cu", "bowtie2_server_tpu/ops/sw_banded.py:240"),
    "sw_banded_general": ("sw_banded.cu",
                          "bowtie2_server_tpu/ops/sw_banded.py:240"),
    "sw_banded_wide": ("sw_banded_wide.cu",
                       "bowtie2_server_tpu/ops/sw_banded.py:240"),
    # no TPU kernel: the JAX package traces back on the host (numpy)
    "sw_banded_tb": ("sw_banded_tb.cu",
                     "bowtie2_server_tpu/ops/sw_banded.py banded_traceback"),
    "sw": ("sw.cu", "bowtie2_server_tpu/ops/sw.py:282"),
    "alu_probe": ("alu_probe.cu", "scripts/bench_dp.py:48"),
    # not TPU kernels: the plain-jnp LF chain the JAX package left to XLA
    # (lf_step stepped by lax.fori_loop), given kernels of its own
    "fm_walk": ("fm.cu", "bowtie2_server_tpu/ops/fm.py:240 lf_step"),
    "fm_lf_step": ("fm.cu", "bowtie2_server_tpu/ops/fm.py:240 lf_step"),
    # the plain-jnp walk-left of a big index (a masked fori_loop)
    "fm_resolve": ("fm.cu",
                   "bowtie2_server_tpu/ops/fm.py:260 resolve_rows_body"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- workload -

def make_genome(seed: int, chrom_len: int, n_contigs: int, contig_len: int):
    """FASTA text and contig code arrays of the synthetic genome."""
    rng = np.random.default_rng(seed)
    contigs = [rng.integers(0, 4, chrom_len).astype(np.uint8)]
    contigs += [rng.integers(0, 4, contig_len).astype(np.uint8)
                for _ in range(n_contigs)]
    bases = np.frombuffer(b"ACGT", np.uint8)
    fa = "".join(f">ctg{i}\n{bases[c].tobytes().decode()}\n"
                 for i, c in enumerate(contigs))
    return fa, contigs


def make_reads(seed: int, contigs, n: int, read_len: int = READ_LEN,
               max_subs: int = 3):
    """bench.py-shaped reads drawn uniformly over the genome (read_len
    bases, 0..max_subs substitutions, 1% with an N, half reverse
    complemented): (names, seqs, quals, origin) with origin = (contig id,
    0-based start, forward?)."""
    rng = np.random.default_rng(seed)
    starts_per = np.array([len(c) - read_len + 1 for c in contigs])
    cum = np.cumsum(starts_per)
    u = rng.integers(0, cum[-1], n)
    cid = np.searchsorted(cum, u, side="right")
    start = u - (cum[cid] - starts_per[cid])
    flat = np.concatenate(contigs)
    off = np.concatenate([[0], np.cumsum([len(c) for c in contigs])[:-1]])
    reads = flat[(off[cid] + start)[:, None] + np.arange(read_len)]
    nmut = rng.integers(0, max_subs + 1, n)
    for k in range(max_subs):
        m = nmut > k
        pos = rng.integers(0, read_len, n)
        reads[m, pos[m]] = rng.integers(0, 4, n).astype(np.uint8)[m]
    with_n = rng.random(n) < 0.01
    reads[with_n, rng.integers(0, read_len, n)[with_n]] = 4
    rc = rng.random(n) < 0.5
    reads[rc] = np.where(reads[rc] < 4, 3 - reads[rc], 4)[:, ::-1]
    arr = np.frombuffer(b"ACGTN", np.uint8)[reads]
    names = [f"b{i}" for i in range(n)]
    seqs = [row.tobytes() for row in arr]
    quals = [b"I" * read_len] * n
    return names, seqs, quals, (cid, start, ~rc)


def make_mixed_reads(seed: int, contigs, n: int, lo: int = 18, hi: int = 60):
    """Reads of lo..hi bases (0-2 substitutions, half reverse complemented)
    drawn from the first contig: (names, seqs, quals)."""
    rng = np.random.default_rng(seed)
    chrom = contigs[0]
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    seqs = []
    for _ in range(n):
        rl = int(rng.integers(lo, hi + 1))
        s = int(rng.integers(0, len(chrom) - rl))
        r = chrom[s : s + rl].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[rng.integers(0, rl)] = rng.integers(0, 4)
        if rng.random() < 0.5:
            r = comp[r][::-1]
        seqs.append(bases[r].tobytes())
    return ([f"m{i}" for i in range(n)], seqs,
            [b"I" * len(q) for q in seqs])


def make_pairs(seed: int, chroms, n: int):
    """bench_paired.py-shaped FR pairs: (names, mate-1 seqs, mate-2 seqs,
    quals, origin) with origin = (chromosome, mate-1 start, mate-2 start);
    mate 1 lies on the forward strand, mate 2 on the reverse."""
    rng = np.random.default_rng(seed)
    gall = np.stack(chroms)
    ci = rng.integers(0, len(chroms), n)
    frag = np.clip(rng.normal(350, 40, n), 300, 600).astype(np.int64)
    st = (rng.random(n) * (gall.shape[1] - frag)).astype(np.int64)
    st2 = st + frag - PAIR_LEN
    offs = np.arange(PAIR_LEN)
    m1 = gall[ci[:, None], st[:, None] + offs]
    m2 = 3 - gall[ci[:, None], st2[:, None] + offs][:, ::-1]
    for m in (m1, m2):                  # 0-3 substitutions per mate
        nmut = rng.integers(0, 4, n)
        for k in range(3):
            sel = nmut > k
            pos = rng.integers(0, PAIR_LEN, n)
            m[sel, pos[sel]] = rng.integers(0, 4, n).astype(np.uint8)[sel]
    # seedless mates 2: a substitution every 16 bases, so no 22-mer seed
    # survives and only mate rescue finds them
    seedless = np.nonzero(rng.random(n) < SEEDLESS_FRAC)[0]
    for r in seedless:
        at = np.arange(int(rng.integers(0, 16)), PAIR_LEN, 16)
        m2[r, at] = (m2[r, at] + rng.integers(1, 4, len(at))) % 4
    bases = np.frombuffer(b"ACGT", np.uint8)
    names = [f"p{i}" for i in range(n)]
    s1 = [row.tobytes() for row in bases[m1]]
    s2 = [row.tobytes() for row in bases[m2]]
    return names, s1, s2, [b"I" * PAIR_LEN] * n, (ci, st, st2)


def placements(recs):
    """(aligned, ref_id, pos, fw) arrays of a batch's records, read from
    the column store where the fast path left them."""
    B = len(recs)
    aligned = np.zeros(B, bool)
    rid = np.full(B, -1, np.int64)
    pos = np.full(B, -1, np.int64)
    fw = np.zeros(B, bool)
    soa = getattr(recs, "soa", None)
    if soa is not None:
        f = soa.filled
        t = soa.tidx[f]
        aligned[f] = True
        rid[f], pos[f], fw[f] = soa.ref_id[t], soa.pos[t], soa.fw[t]
    items = (recs.cache_items() if hasattr(recs, "cache_items")
             else enumerate(recs))
    for i, r in items:
        aligned[i], rid[i], pos[i], fw[i] = r.aligned, r.ref_id, r.pos, r.fw
    return aligned, rid, pos, fw


def pair_origin_fraction(pairs, origin) -> float:
    """Fraction of pairs with both mates at their planted origin and
    strand."""
    ci, st1, st2 = origin
    a1, rid1, pos1, fw1 = placements(pairs.r1)
    a2, rid2, pos2, fw2 = placements(pairs.r2)
    ok = (a1 & a2 & (rid1 == ci) & (rid2 == ci) & fw1 & ~fw2
          & (pos1 == st1) & (pos2 == st2))
    return float(ok.mean())


def origin_fraction(recs, origin, local: bool, read_len=READ_LEN) -> float:
    aligned, rid, pos, fw = placements(recs)
    cid, start, ofw = origin
    ok = aligned & (rid == cid) & (fw == ofw)
    if local:    # soft clipping moves the start inside the read span
        ok &= (pos >= start) & (pos < start + read_len)
    else:
        ok &= pos == start
    return float(ok.mean())


# --------------------------------------------------------------- phases -

def phase_env():
    import torch
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the card")
    line = card_line()
    log(f"card: {line}")
    return line


def phase_build():
    from bowtie2_server_tpu_torch.ops import kernels
    so, build_log, sec = kernels.build()
    log(f"kernels built in {sec:.2f} s: {so.name}")
    for ln in build_log.splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("=="):
            log("  " + ln.strip())
    kernels.lib()


def hold(label: str, arg, kernel, plain, symbol: str):
    """kernel(arg) against plain(arg), both returning tuples of int32 CUDA
    tensors (or one tensor): logs and returns (max_abs_err, kernel ms,
    plain ms, kernel event ms). The kernel's ms is the device time of its
    launch whose profiler name contains `symbol` (bench_dp.device_ms); the
    event ms brackets a call with CUDA events, the wrapper's host work
    included, as the plain version's ms does."""
    import torch
    from bowtie2_server_tpu_torch.scripts.bench_dp import device_ms, time_ms
    got, want = kernel(arg), plain(arg)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    dev = torch.device("cuda")
    ms = device_ms(lambda: kernel(arg), dev, symbol, reps=5)
    ems = time_ms(lambda: kernel(arg), dev, reps=5)
    pms = time_ms(lambda: plain(arg), dev, reps=3)
    log(f"{label} max_abs_err={err} kernel {ms:.4f} ms (events {ems:.4f} "
        f"ms), plain {pms:.3f} ms")
    return err, ms, pms, ems


def summary(runs, bnd):
    """The largest error of `runs` (hold() results), the times of the
    first, and the first's bound `bnd` (ms, "bytes" or "operations") with
    the share of it the kernel reached."""
    err, ms, pms, ems = max(r[0] for r in runs), *runs[0][1:]
    return dict(max_abs_err=err, ms=ms, event_ms=ems, plain_ms=pms,
                bound_ms=bnd[0], bound_by=bnd[1], frac_of_bound=bnd[0] / ms)


def phase_kernels(contigs):
    """Each kernel against its plain torch version on the same CUDA
    tensors. Returns per-kernel {max_abs_err, ms, plain_ms, bound_ms,
    bound_by, frac_of_bound, ...}."""
    import torch
    from bowtie2_server_tpu_torch.ops import alu_probe, kernels
    from bowtie2_server_tpu_torch.ops import sw as tsw
    from bowtie2_server_tpu_torch.ops import sw_banded as tsb
    from bowtie2_server_tpu_torch.scripts import (bench_banded, bench_dp,
                                                  bench_rect)
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_tiles import (CFGS, LARGE_SCORE_CFG, banded_edge_tile,
                             rect_tie_tile)
    dev = torch.device("cuda")
    modes = [("e2e", tsw.SwConfig()),
             ("local", tsw.SwConfig(ma=2, local=True))]

    def wide_runs(K, args):
        """hold() of the wide-band kernel (also at K = 128, where banded_dp
        routes to the register kernel), in both modes."""
        return [hold(f"sw_banded_wide {mode}: Lq={args[0].shape[0]} K={K} "
                     f"P={args[0].shape[1]}", cfg,
                     lambda c: tsb._launch("sw_banded_wide", c, K, *args),
                     lambda c: tsb.banded_tile_torch(c, K, *args),
                     "banded_wide_kernel")
                for mode, cfg in modes]

    def inputs(seed, P, K, lq):
        arrs = bench_banded.banded_inputs(seed, P, K, lq, chrom=contigs[0])
        return arrs, [torch.from_numpy(a).to(dev) for a in arrs]

    # the wide-band kernel at K = 128 (--dpad 16-31, where banded_dp routes
    # to the register kernel, timed beside it below; bound once the probe
    # has run)
    lq, P = 128, 33792
    arrs, args = inputs(9, P, 128, lq)
    wide128 = (wide_runs(128, args), arrs[2])

    # the ALU-ceiling probe at the DP microbench's shape, after the banded
    # kernels have run the card up to its clocks: its rate is the int32
    # ceiling of every bound, and its bound is its own time
    rows, P, nsteps = 64, 32768, 3000
    x = torch.from_numpy(np.random.default_rng(8).integers(
        0, 100, (rows, P)).astype(np.int32)).to(dev)
    run = hold(f"alu_probe: [{rows}, {P}] nsteps={nsteps}", nsteps,
               lambda n: alu_probe.alu_chain(x, n),
               lambda n: alu_probe.alu_chain_torch(x, n), "alu_kernel")
    n_ops = alu_probe.OPS_PER_STEP * nsteps * rows * P
    # the profiler's time unless it strays from the event time (bench_dp)
    probe, clock = bench_dp.probe_ms(run[1], run[3])
    ceiling = n_ops / (probe / 1e3)
    log(f"int32 ceiling measured by the probe: {ceiling:.4e} ops/s, from "
        f"its {'profiler' if clock == 'device' else 'CUDA-event'} time "
        f"{probe:.4f} ms (profiler {run[1]:.4f}, events {run[3]:.4f})")
    out = {"alu_probe": dict(
        summary([run], bench_rect.bound(n_ops, 0, ceiling)),
        ceiling_ops_per_s=ceiling, ceiling_clock=clock,
        bound_note="the probe's own time: it measures the int32 ceiling "
                   "that the other kernels' bounds divide by")}
    k128 = summary(wide128[0], bench_banded.banded_bound(
        wide128[1], lq, 128, False, ceiling))

    # the three banded kernels at bench_banded's shapes (the fused stage's
    # P = 33792, Lq = 128), e2e and local: the register kernel at K = 64
    # with 4 in 5 problems of length 128, K = 64 with every length 100 (the
    # main path's mix), K = 32 and K = 128; the wide-band kernel at K = 256
    # (both mixes) and K = 512; the general kernel at the k64 shape under
    # LARGE_SCORE_CFG. Reported: k64 e2e, k256 e2e and the general row.
    brows = bench_banded.measure(dev, ceiling, reps=5, plain_reps=3,
                                 chrom=contigs[0])
    for r in brows:
        log(f"{r['kernel'].strip(':<')} {r['shape']} {r['mode']}: Lq={r['lq']} K={r['K']} "
            f"P={r['P']} max_abs_err={r['max_abs_err']} kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['frac_of_bound']:.4f} of bound")
    # the SASS of the row loops: the register kernel's gap-row loop (its
    # largest), the wide-band kernel's and the general kernel's loops over
    # gap rows on their tables (sw_banded.wide_loop, general_loop)
    loop = {}
    for K in (32, 64, 128):
        for local in (False, True):
            n, mix = kernels.loop_mix(f"banded_kernelILi{K}ELb{int(local)}E")
            loop[f"K{K}{'_local' if local else ''}"] = n / K
            log(f"banded kernel row loop, K = {K}, "
                f"{'local' if local else 'e2e'} (SASS): {n} instructions, "
                f"{n / K:.2f} a cell {mix}")
    wloop = {}
    for K in (128, 256, 512, 1024):
        for local in (False, True):
            n, mix = kernels.loop_mix(*tsb.wide_loop(K, local))
            cells = tsb.wide_cells(local)
            wloop[f"K{K}{'_local' if local else ''}"] = n / cells
            log(f"wide-band kernel gap-row loop, K = {K}, "
                f"{'local' if local else 'e2e'} (SASS, a lane's {cells} "
                f"cells): {n} instructions, {n / cells:.2f} a cell {mix}")
    gloop = {}
    for local in (False, True):
        n, mix = kernels.loop_mix(*tsb.general_loop(64, local))
        gloop[f"K64{'_local' if local else ''}"] = n / 64
        log(f"general kernel gap-row loop (int16 tables), K = 64, "
            f"{'local' if local else 'e2e'} (SASS): {n} instructions, "
            f"{n / 64:.2f} a cell {mix}")
    # and exact on the edge tile of tests/torch_tiles.py at every band
    # (P = 129, lengths from < 0 to past Lq, penalties past the byte
    # scores' range) under every scoring of the tests
    edge_err = {}
    for K in tsb.KERNEL_BANDS:
        edge = [torch.from_numpy(a).to(dev)
                for a in banded_edge_tile(5 * K, 40, K)]
        for name, kw in dict(CFGS, large_scores=LARGE_SCORE_CFG).items():
            cfg = tsw.SwConfig(**kw)
            got = tsb.banded_dp(cfg, K, *edge)
            want = tsb.banded_tile_torch(cfg, K, *edge)
            which = "sw_banded" if K <= 128 else "sw_banded_wide"
            edge_err[which] = max([edge_err.get(which, 0)] + [
                int((g - w).abs().max()) for g, w in zip(got, want)])
    log(f"banded edge tile, K = {tsb.KERNEL_BANDS}, {len(CFGS) + 1} "
        f"scorings: max_abs_err {edge_err}")

    def report(row, **extra):
        return dict(**{k: row[k] for k in ("ms", "event_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "frac_of_bound")}, **extra)

    reg = [r for r in brows if r["K"] <= 128 and r["mode"] != "large_scores"]
    wide = [r for r in brows if r["K"] > 128]
    gen = next(r for r in brows if r["mode"] == "large_scores")
    out["sw_banded"] = report(
        reg[0], max_abs_err=max([edge_err["sw_banded"]]
                                + [r["max_abs_err"] for r in reg]),
        shapes=reg, row_loop_instructions_per_cell=loop)
    out["sw_banded_wide"] = report(
        wide[0], max_abs_err=max([edge_err["sw_banded_wide"], k128[
            "max_abs_err"]] + [r["max_abs_err"] for r in wide]),
        shapes=wide, k128=k128, row_loop_instructions_per_cell=wloop)
    fast = next(r for r in brows if r["shape"] == "k64" and
                r["mode"] == "local")
    log(f"  general kernel beside the register kernel at its shape, local: "
        f"{gen['ms']:.4f} against {fast['ms']:.4f} ms")
    out["sw_banded_general"] = report(
        gen, max_abs_err=max(gen["max_abs_err"], edge_err["sw_banded"]),
        row_loop_instructions_per_cell=gloop)

    # the rectangle kernel at bench_rect's three shapes, e2e and local; the
    # unpaired path's shape (P = 210) is the one reported
    shapes = bench_rect.measure(dev, ceiling, reps=5, plain_reps=3)
    for r in shapes:
        log(f"sw (rect) {r['shape']} {r['mode']}: Lq_pad={r['lq_pad']} "
            f"Lc={r['lc']} P={r['P']} max_abs_err={r['max_abs_err']} kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['frac_of_bound']:.4f} of bound")
    # and exact on the tie-heavy tile at the mate-rescue widths
    tie = [torch.from_numpy(a).to(dev) for a in rect_tie_tile(3, 192, 640)]
    tie_err = 0
    for mode, cfg in modes:
        got, want = tsw.sw_tile(cfg, *tie), tsw.sw_tile_torch(cfg, *tie)
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        log(f"sw (rect) tie-heavy tile {mode}: Lq_pad={tie[0].shape[0]} "
            f"Lc={tie[3].shape[0]} P={tie[0].shape[1]} max_abs_err={err}")
        tie_err = max(tie_err, err)
    # the SASS of a wavefront step at the paths' row widths (J rows a lane)
    loop = {}
    for J in (4, 6):
        n, mix = kernels.loop_mix(f"rect_warp_kernelILi{J}ELb0E")
        loop[f"J{J}"] = n
        log(f"rect kernel step loop, J = {J}, e2e (SASS): {n} instructions "
            f"{mix}")
    main = next(r for r in shapes if r["shape"] == "unpaired")
    out["sw"] = dict(
        max_abs_err=max([tie_err] + [r["max_abs_err"] for r in shapes]),
        **{k: main[k] for k in ("ms", "event_ms", "plain_ms", "bound_ms",
                                "bound_by", "frac_of_bound")}, shapes=shapes,
        step_loop_instructions=loop)
    for name, r in out.items():
        log(f"{name}: {r['ms']:.4f} ms against a bound of "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['frac_of_bound']:.4f} of it")
        if r["max_abs_err"] != 0:
            raise RuntimeError(f"{name}: kernel disagrees with its plain "
                               f"version (max_abs_err {r['max_abs_err']})")
    return out


def pipelined(submit, wait, items, depth):
    """Submit every item, keeping at most `depth` in flight; the results in
    order."""
    outs, inflight = [], deque()
    for it in items:
        inflight.append(submit(*it))
        if len(inflight) >= depth:
            outs.append(wait(inflight.popleft()))
    while inflight:
        outs.append(wait(inflight.popleft()))
    return outs


def profile_device(fn):
    """fn() under torch.profiler. Returns (wall ms, {name: [count, device
    us]}) over the card's activities (kernels, copies, fills)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = per.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    return wall, per


def device_shares(label, prof, n_batches):
    """Log and return, from profile_device's result over n_batches batches,
    the device busy share and, for each kernel of SHARE_SYMBOLS, its
    launches, device ms, ms a launch and share of device time."""
    wall, per = prof
    total = sum(us for _, us in per.values())
    if total == 0:
        log(f"{label}: device time not measured (the profiler saw no "
            f"device activity)")
        return None
    out = dict(batches=n_batches, wall_ms=wall, device_ms=total / 1e3,
               busy_share=total / 1e3 / wall)
    for key, sym in SHARE_SYMBOLS.items():
        n = sum(c for k, (c, _) in per.items() if sym in k)
        us = sum(t for k, (_, t) in per.items() if sym in k)
        out.update({f"{key}_launches": n, f"{key}_ms": us / 1e3,
                    f"{key}_ms_per_launch": us / 1e3 / max(n, 1),
                    f"{key}_share": us / total})
        log(f"{label}, {n_batches} batches under torch.profiler: the {key} "
            f"kernel {n} launches, {us / 1e3:.4f} ms of device time "
            f"({us / 1e3 / max(n, 1):.4f} ms a launch), {us / total:.4f} of "
            f"it")
    log(f"{label}: device busy {total / 1e3:.1f} ms in {wall:.1f} ms of "
        f"wall, a busy share of {out['busy_share']:.4f}")
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (c, us) in top:
        log(f"  {us / total:.4f} {us / 1e3:9.3f} ms {c:6d}x {name[:90]}")
    return out


def run_main_path(idx, contigs, device, batch, n_batches, seed=11):
    """bench.py's loop on the port: one warm-up batch, then n_batches at
    dispatch depth DEPTH, then PROFILED batches under torch.profiler.
    Returns (reads/s, aligned fraction, origin fraction, warm-up seconds,
    the profile)."""
    import torch
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    names, seqs, quals, origin = make_reads(
        seed, contigs, batch * (n_batches + 1 + PROFILED))
    batches = [(make_batch(names[i : i + batch], seqs[i : i + batch],
                           quals[i : i + batch]),)
               for i in range(0, len(names), batch)]
    al = UnpairedAligner(idx, device=device)
    t0 = time.time()
    outs = [al.align_batch(*batches[0])]
    warm = time.time() - t0
    t0 = time.time()
    outs += pipelined(al.align_async, al.align_wait,
                      batches[1 : n_batches + 1], DEPTH)
    torch.cuda.synchronize()
    dt = time.time() - t0
    prof = profile_device(lambda: pipelined(
        al.align_async, al.align_wait, batches[n_batches + 1 :], DEPTH))
    n = batch * n_batches
    aligned = sum(r.n_aligned() for r in outs[1:]) / n
    frac = np.mean([origin_fraction(r, tuple(o[i * batch : (i + 1) * batch]
                                             for o in origin), False)
                    for i, r in enumerate(outs)])
    return n / dt, aligned, float(frac), warm, prof


def run_local_batch(idx, contigs, device, batch, seed=12):
    from bowtie2_server_tpu_torch.align.pipeline import (SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.utils.presets import preset_params
    names, seqs, quals, origin = make_reads(seed, contigs, batch)
    sc, pol = preset_params(None, True)
    al = UnpairedAligner(idx, scoring=sc, policy=SearchPolicy(**pol),
                         device=device)
    t0 = time.time()
    recs = al.align_batch(make_batch(names, seqs, quals))
    dt = time.time() - t0
    return (batch / dt, recs.n_aligned() / batch,
            origin_fraction(recs, origin, True))


def phase_main(idx, contigs, local=True):
    import torch
    from bowtie2_server_tpu_torch.ops import kernels
    kernels.reset_launches()
    rps, aligned, frac, warm, prof = run_main_path(idx, contigs, "cuda",
                                                   BATCH, N_BATCHES)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_all = 1 + N_BATCHES + PROFILED
    log(f"main path (e2e): {rps:.1f} reads/s over {N_BATCHES} batches of "
        f"{BATCH} at depth {DEPTH} (warm-up batch {warm:.2f} s); aligned "
        f"{aligned:.4f}; at planted origin and strand {frac:.4f}; "
        f"kernel launches over all {n_all} batches {launches}; the rect "
        f"kernel {launches['sw'] / n_all:.2f} a batch")
    shares = device_shares("main path (e2e)", prof, PROFILED)
    if frac < ORIGIN_MIN_E2E:
        raise RuntimeError(f"origin fraction {frac:.4f} < {ORIGIN_MIN_E2E}")
    for name in ("sw_banded", "sw_banded_general", "sw"):
        if launches[name] == 0:
            raise RuntimeError(f"the main path never launched {name}")
    if not local:
        return launches, dict(reads_per_s=rps, origin=frac, device=shares)
    # the --local batch's launches alone: every --local winner is traced,
    # so the traceback kernel runs there
    kernels.reset_launches()
    l_rps, l_aligned, l_frac = run_local_batch(idx, contigs, "cuda",
                                               LOCAL_BATCH)
    torch.cuda.synchronize()
    launches["local_sw_banded_tb"] = kernels.LAUNCHES["sw_banded_tb"]
    log(f"main path (--local, one batch of {LOCAL_BATCH}): {l_rps:.1f} "
        f"reads/s; "
        f"aligned {l_aligned:.4f}; origin inside the read span and strand "
        f"{l_frac:.4f}")
    if l_frac < ORIGIN_MIN_LOCAL:
        raise RuntimeError(f"local origin fraction {l_frac:.4f} < "
                           f"{ORIGIN_MIN_LOCAL}")
    if launches["local_sw_banded_tb"] == 0:
        raise RuntimeError("the --local batch never launched sw_banded_tb")
    return launches, dict(reads_per_s=rps, origin=frac,
                          local_reads_per_s=l_rps, device=shares)


# phase TB: (label, problems, --local); K = 64, 100 bp reads
TB_SHAPES = (("e2e", 64, False), ("local", 4096, True))


def tb_ops_per_cell(local: bool) -> int:
    """int32 operations a cell of the traceback kernel's fill, counted as
    bench_banded.banded_ops_per_cell counts (each add, compare, max,
    select and or one): the recurrence, 10, with --local's clamp at 0, 1
    (no running max: the end cell is given); the direction byte's tests,
    H == diagonal, H == E, H == F, and the two extensions (E == E_left -
    rdg_ext, F == F_up - rfg_ext, their subtractions the recurrence's
    own), 5, and their 5 bits packed, 5. --local adds, for each of the
    three H tests, the source's sign test and its and, 6, and the zero
    test with its bit, 2. A lower bound: the kernel's own loop
    (kernel_ops_per_cell in the result) also moves the band codes and
    runs the E scan over the lanes."""
    return 20 + 9 * int(local)


def phase_tb(ceiling=None):
    """Phase TB: banded_traceback_batch's kernel against the oracle, with
    its device time and bound at TB_SHAPES. The bound: the cells it fills
    (rows 0..bi of each problem, K a row) x tb_ops_per_cell over the int32
    ceiling, or its bytes (inputs, direction bytes and edits written) over
    HBM's 3.35e12 B/s, the larger; the walk, one dependent byte load a
    step, is not in it. call_ms: the whole banded_traceback_batch call on
    the host's clock (copies in and out, the edit lists)."""
    import torch
    from bowtie2_server_tpu_torch.ops import kernels
    from bowtie2_server_tpu_torch.ops import sw as tsw
    from bowtie2_server_tpu_torch.ops import sw_banded as tsb
    from bowtie2_server_tpu_torch.scripts.bench_dp import (
        device_ms, measure_alu_ceiling)
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_tiles import traceback_problems
    dev = torch.device("cuda")
    if ceiling is None:
        ceiling, _ = measure_alu_ceiling(dev)
    K, res, t_phase = 64, {}, time.time()
    for label, P, local in TB_SHAPES:
        cfg = tsw.SwConfig(ma=2, local=True) if local else tsw.SwConfig()
        rd, mm, band, lens = traceback_problems(64 + P, P, K, 100, 100)

        def put(a):
            return torch.from_numpy(
                np.ascontiguousarray(a.T.astype(np.int32))).to(dev)
        _, bi, bk = tsb.banded_dp(cfg, K, put(rd), put(mm),
                                  torch.from_numpy(lens.copy()).to(dev),
                                  put(band))
        bi, bk = bi.cpu().numpy(), bk.cpu().numpy()

        def call():
            return tsb.banded_traceback_batch(rd, mm, band, lens, bi, bk,
                                              cfg, K, device=dev)
        got, on_card = call()
        bad = sum(got[t] != tsb.banded_traceback(
            rd[t, :100], mm[t, :100], band[t, : 100 + K], cfg, int(bi[t]),
            int(bk[t]), K=K) for t in range(P))
        if bad or not on_card.all():
            raise RuntimeError(f"TB {label}: {bad} of {P} tracebacks differ "
                               f"from the oracle, {int((~on_card).sum())} "
                               f"left to it")
        n0 = kernels.LAUNCHES["sw_banded_tb"]
        ms = device_ms(call, dev, "traceback_kernel", reps=5)
        t0 = time.time()
        for _ in range(3):
            call()
        call_ms = (time.time() - t0) / 3 * 1e3
        cells = int((bi.astype(np.int64) + 1).sum()) * K
        n_edits = sum(len(g[0]) for g in got)
        nbytes = 4 * (rd.size + mm.size + band.size + 5 * P) + cells \
            + 16 * (n_edits + P)
        opc = tb_ops_per_cell(local)
        bound = max(cells * opc / ceiling, nbytes / 3.35e12) * 1e3
        by = ("operations" if cells * opc / ceiling >= nbytes / 3.35e12
              else "bytes")
        # the fill loop's SASS instructions a lane issues a row, over the
        # K / 32 cells it owns
        n, mix = kernels.loop_mix(f"traceback_kernelILi{K}ELb{int(local)}E")
        res[label] = dict(P=P, K=K, ms=ms, call_ms=call_ms, bound_ms=bound,
                          bound_by=by, frac_of_bound=bound / ms,
                          cells=cells, scratch_bytes=P * 100 * K,
                          ops_per_cell=opc, kernel_ops_per_cell=n / (K // 32),
                          launches=kernels.LAUNCHES["sw_banded_tb"] - n0)
        log(f"TB {label} P={P} K={K} 100 bp: equals the oracle on all {P}; "
            f"kernel {ms:.4f} ms, the whole call {call_ms:.2f} ms; bound "
            f"{bound:.4f} ms ({by}, {opc} ops a cell), {bound / ms:.3f} of "
            f"it; {cells} cells; the fill loop (SASS): {n} instructions a "
            f"row, {n / (K // 32):.1f} a cell {mix}")
    log(f"phase TB in {time.time() - t_phase:.1f} s on {card_line()}")
    return dict(max_abs_err=0, ms=res["e2e"]["ms"],
                call_ms=res["e2e"]["call_ms"], plain_ms=None,
                bound_ms=res["e2e"]["bound_ms"],
                bound_by=res["e2e"]["bound_by"],
                frac_of_bound=res["e2e"]["frac_of_bound"], shapes=res)


def phase_dp_bench():
    """The DP microbench through its module, at the reference bench's shape
    and at the main path's banded shape. Its path is the probe's: the
    counters are zeroed before and read after."""
    from bowtie2_server_tpu_torch.ops import kernels
    from bowtie2_server_tpu_torch.scripts import bench_dp
    kernels.reset_launches()
    ref = bench_dp.run("cuda", P=32768, L=100, K=32)
    main = bench_dp.run("cuda", P=33792, L=128, K=64,
                        ceiling=ref["ceiling_ops_per_s"])
    launches = dict(kernels.LAUNCHES)
    for r in (ref, main):
        log(f"DP microbench P={r['P']} L={r['L']} K={r['K']}: "
            f"{r['value']:.4e} cells/s ({r['kernel_ms']:.4f} ms), ceiling "
            f"{r['ceiling_ops_per_s']:.4e} int32 ops/s, roofline_frac "
            f"{r['roofline_frac']:.4f} at {r['ops_per_cell']} ops/cell; the "
            f"kernel's own loop: {r['kernel_ops_per_cell']:.2f} "
            f"instructions/cell")
        log("  " + json.dumps(r))
    n, mix = kernels.loop_mix("alu_kernel")
    log(f"ALU probe loop (SASS): {n} instructions {mix}")
    for name in ("alu_probe", "sw_banded"):
        if launches[name] == 0:
            raise RuntimeError(f"the DP microbench never launched {name}")
    return launches


def run_paired_path(idx, chroms, device, batch, n_batches, seed=21):
    """bench_paired.py's loop on the port: one warm-up pair batch, then
    n_batches at dispatch depth PAIR_DEPTH, then PROFILED pair batches
    under torch.profiler. Returns (pairs/s, concordant fraction, origin
    fraction, warm-up seconds, the profile)."""
    import torch
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    names, s1, s2, quals, origin = make_pairs(
        seed, chroms, batch * (n_batches + 1 + PROFILED))
    b1s, b2s = ([make_batch(names[i : i + batch], s[i : i + batch],
                            quals[i : i + batch])
                 for i in range(0, len(names), batch)] for s in (s1, s2))
    pairs = list(zip(b1s, b2s))
    pal = PairedAligner(idx, device=device)
    t0 = time.time()
    outs = [pal.align_batch(*pairs[0])]
    warm = time.time() - t0
    t0 = time.time()
    outs += pipelined(pal.align_async, pal.align_wait,
                      pairs[1 : n_batches + 1], PAIR_DEPTH)
    torch.cuda.synchronize()
    dt = time.time() - t0
    prof = profile_device(lambda: pipelined(
        pal.align_async, pal.align_wait, pairs[n_batches + 1 :],
        PAIR_DEPTH))
    n = batch * n_batches
    conc = sum(p.n_concordant() for p in outs[1:]) / n
    frac = np.mean([pair_origin_fraction(p, tuple(
        o[i * batch : (i + 1) * batch] for o in origin))
        for i, p in enumerate(outs)])
    return n / dt, conc, float(frac), warm, prof


def phase_paired(pidx, chroms):
    import torch
    from bowtie2_server_tpu_torch.ops import kernels
    kernels.reset_launches()
    pps, conc, frac, warm, prof = run_paired_path(pidx, chroms, "cuda",
                                                  PAIR_BATCH, PAIR_BATCHES)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_all = 1 + PAIR_BATCHES + PROFILED
    log(f"paired path (e2e): {pps:.1f} pairs/s over {PAIR_BATCHES} batches "
        f"of {PAIR_BATCH} pairs at depth {PAIR_DEPTH} (warm-up batch "
        f"{warm:.2f} s); concordant {conc:.4f}; both mates at planted "
        f"origin and strand {frac:.4f}; kernel launches over all {n_all} "
        f"batches {launches}; the rect kernel {launches['sw'] / n_all:.2f} "
        f"a batch")
    shares = device_shares("paired path (e2e)", prof, PROFILED)
    if frac < PAIR_ORIGIN_MIN:
        raise RuntimeError(f"pair origin fraction {frac:.4f} < "
                           f"{PAIR_ORIGIN_MIN}")
    for name in ("sw_banded", "sw_banded_general", "sw"):
        if launches[name] == 0:
            raise RuntimeError(f"the paired path never launched {name}")
    return launches, dict(pairs_per_s=pps, origin=frac, device=shares)


def srv_placement(lines, origin, contig_names) -> float:
    """Fraction of one unpaired client's reads at their planted origin and
    strand, by restored name; origin maps a name to (contig id, 0-based
    start, forward?). Raises unless every read has exactly one record."""
    recs = {}
    for line in lines:
        f = line.split("\t", 4)
        if f[0] in recs:
            raise RuntimeError(f"server: read {f[0]} answered twice")
        recs[f[0]] = f
    if set(recs) != set(origin):
        raise RuntimeError(f"server: {len(set(origin) - set(recs))} reads "
                           f"unanswered, {len(set(recs) - set(origin))} "
                           f"names not sent")
    ok = sum(f[2] == contig_names[c] and int(f[3]) == s + 1
             and ((int(f[1]) & 16) == 0) == bool(fw)
             for name, (c, s, fw) in origin.items()
             for f in (recs[name],))
    return ok / len(origin)


def srv_pair_placement(lines, origin, chrom_names) -> float:
    """Fraction of one paired client's pairs with both mates at their
    planted origin and strand (mate 1 forward, mate 2 reverse); origin
    maps a name to (chromosome, mate-1 start, mate-2 start). Raises unless
    every pair has its two records, mate 1's then mate 2's."""
    recs = {}
    for line in lines:
        f = line.split("\t", 4)
        recs.setdefault(f[0], []).append(f)
    if set(recs) != set(origin) or any(len(v) != 2 for v in recs.values()):
        raise RuntimeError("server: a pair without its two records")
    ok = 0
    for name, (c, s1, s2) in origin.items():
        a, b = recs[name]
        fa, fb = int(a[1]), int(b[1])
        if not (fa & 0x40 and fb & 0x80):
            raise RuntimeError(f"server: pair {name} records out of order")
        ok += (a[2] == b[2] == chrom_names[c] and int(a[3]) == s1 + 1
               and int(b[3]) == s2 + 1 and not fa & 16 and fb & 16 > 0)
    return ok / len(origin)


def srv_clients(port, loads):
    """Runs one port Bt2Client a load at once, each in a thread of its own;
    loads: lists of rows. Returns (each client's SAM lines, seconds from
    the first send to the last "All Done"). Any client's failure (the
    server failed a pack) fails the phase."""
    import threading
    from bowtie2_server_tpu_torch.server.client import Bt2Client
    outs, errors, ends = [None] * len(loads), [], [0.0] * len(loads)

    def run(k):
        try:
            cl = Bt2Client("127.0.0.1", port, "genome")
            cl.send_reads(loads[k])
            outs[k] = list(cl.finish())
            ends[k] = time.time()
        except Exception as e:          # re-raised on the phase's thread
            errors.append((k, e))

    threads = [threading.Thread(target=run, args=(k,), daemon=True)
               for k in range(len(loads))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors:
        raise RuntimeError(f"server: client {errors[0][0]} failed: "
                           f"{errors[0][1]!r}") from errors[0][1]
    if any(o is None for o in outs):
        raise RuntimeError("server: a client did not finish in 600 s")
    return outs, max(ends) - t0


def srv_timers():
    """Turns the port's span recorder on (utils/trace.py); returns the
    wall-clock time from which srv_breakdown reads its spans."""
    from bowtie2_server_tpu_torch.utils import trace
    trace.enable()
    return time.time()


def srv_breakdown(label, t0, wall):
    """Logs and returns the worker's share of the load's wall time, from
    the recorder's spans since t0: whole packs (`srv.pack`), inside them
    the records taken out of the aligners' results (`srv.records`) and the
    SAM text (`srv.sam`); the rest of a pack is building its batches and
    the aligners, of which the wait on the card's output (`cg.fetch`)."""
    from bowtie2_server_tpu_torch.utils import trace
    tot = {}
    for sp in trace.spans(t0):
        tot[sp.name] = tot.get(sp.name, 0.0) + sp.s
    packs = tot.get("srv.pack", 0.0)
    fmt = tot.get("srv.records", 0.0) + tot.get("srv.sam", 0.0)
    fetch = tot.get("cg.fetch", 0.0)
    out = dict(worker_s=packs, format_s=fmt, fetch_s=fetch,
               worker_share=packs / wall, format_share=fmt / wall,
               align_share=(packs - fmt) / wall)
    log(f"server ({label}) load: the worker thread in packs "
        f"{packs:.3f} s of {wall:.3f} s wall ({out['worker_share']:.4f}): "
        f"records and SAM text {fmt:.3f} s ({out['format_share']:.4f}), "
        f"batch building and the aligners {packs - fmt:.3f} s "
        f"({out['align_share']:.4f}; the wait on the card's output "
        f"{fetch:.3f} s); the rest of the wall is parsing, client work and "
        f"waiting")
    return out


def srv_exact(srv, port, rows, cpu_worker, label):
    """One raw tab6 request of `rows` (fixed names) to the card's server,
    held line by line against Bt2Server._align_pack of the same rows, a
    pack at a time, on CPU aligners. Returns the request's seconds."""
    from bowtie2_server_tpu_torch.server.bt2srv import Bt2Server
    from torch_serving import raw_request, tab6_line
    names = [n.split()[0] if n.split() else n for n in srv.idx.ref_names]
    t0 = time.time()
    _, body = raw_request(port, [tab6_line(r) for r in rows])
    dt = time.time() - t0
    want = b"".join(Bt2Server._align_pack(
        cpu_worker, rows[k : k + srv.batch_size], names)
        for k in range(0, len(rows), srv.batch_size))
    want += b"@CO BT2SRV All Done\n"
    got, exp = body.split(b"\n"), want.split(b"\n")
    diff = sum(a != b for a, b in zip(got, exp)) + abs(len(got) - len(exp))
    if diff:
        raise RuntimeError(f"server, {label}: {diff} lines of the card's "
                           f"response differ from the CPU _align_pack "
                           f"({len(got)} and {len(exp)} lines)")
    log(f"server CUDA vs CPU, {label}: {len(rows)} rows, {len(got)} "
        f"response lines identical to _align_pack on CPU aligners")
    return dt


def phase_server(base, contigs, pbase, chroms):
    """Phase SRV: the port's BT2SRV server on the card, one on phase 4's
    genome and one on phase PE's, each with the JAX server's pack size
    (FLUSH_READS) on an event loop of its own thread; its packs run on the
    server's worker thread. A raw request with fixed names to each is held
    line by line against _align_pack on CPU aligners; then concurrent port
    clients load each server. Returns the paths line's "server" entry."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_serving import serving
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.ops import kernels
    from bowtie2_server_tpu_torch.server.bt2srv import FLUSH_READS, Bt2Server
    out = {}
    t_phase = time.time()
    # the unpaired server: exactness on reads of 18-100 bp (packs with the
    # fast and the general shape), then the main path's 100 bp reads
    srv = Bt2Server(str(base), device="cuda")
    try:
        if srv.batch_size != FLUSH_READS:
            raise RuntimeError(f"server packs of {srv.batch_size}, not "
                               f"the JAX server's {FLUSH_READS}")
        with serving(srv) as port:
            names, seqs, quals = make_mixed_reads(61, contigs, SRV_EXACT,
                                                  lo=18, hi=100)
            rows = [(n, s, q, None, None, None)
                    for n, s, q in zip(names, seqs, quals)]
            pal = PairedAligner(srv.idx, device="cpu")
            kernels.reset_launches()
            first = srv_exact(srv, port, rows, (pal.up, pal),
                              f"{SRV_EXACT} reads of 18-100 bp")
            loads, origins = [], []
            for c in range(SRV_CLIENTS):
                names, seqs, quals, (cid, st, fw) = make_reads(
                    70 + c, contigs, SRV_READS)
                names = [f"c{c}r{i}" for i in range(SRV_READS)]
                loads.append(list(zip(names, seqs, quals)))
                origins.append(dict(zip(names, zip(cid, st, fw))))
            timers = srv_timers()
            lines, wall = srv_clients(port, loads)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    finally:
        srv.close()
    ctg = [f"ctg{i}" for i in range(len(contigs))]
    frac = min(srv_placement(ln, o, ctg) for ln, o in zip(lines, origins))
    rps = SRV_CLIENTS * SRV_READS / wall
    log(f"server (unpaired, {SRV_CLIENTS} concurrent clients x {SRV_READS} "
        f"reads of {READ_LEN} bp, packs of {FLUSH_READS}): {rps:.1f} reads/s "
        f"({wall:.2f} s from the first send to the last All Done, host "
        f"clock); first request {first:.3f} s; every read answered once; "
        f"at planted origin and strand, the lowest client {frac:.4f}; "
        f"kernel launches over the phase {launches}")
    if frac < SRV_ORIGIN_MIN:
        raise RuntimeError(f"server origin fraction {frac:.4f} < "
                           f"{SRV_ORIGIN_MIN}")
    if launches["sw_banded"] == 0:
        raise RuntimeError("the unpaired server never launched sw_banded")
    out.update(reads_per_s=rps, origin=frac, first_request_s=first,
               launches=launches,
               host=srv_breakdown("unpaired", timers, wall))
    # the paired server: exactness on pairs, then paired clients
    srv = Bt2Server(str(pbase), device="cuda")
    try:
        with serving(srv) as port:
            names, s1, s2, quals, _ = make_pairs(62, chroms, SRV_EXACT_PAIRS)
            rows = [(n + "/1", a, q, n + "/2", b, q)
                    for n, a, b, q in zip(names, s1, s2, quals)]
            pal = PairedAligner(srv.idx, device="cpu")
            kernels.reset_launches()
            pfirst = srv_exact(srv, port, rows, (pal.up, pal),
                               f"{SRV_EXACT_PAIRS} pairs")
            loads, origins = [], []
            for c in range(SRV_PAIR_CLIENTS):
                names, s1, s2, quals, (ci, st1, st2) = make_pairs(
                    80 + c, chroms, SRV_PAIRS)
                names = [f"c{c}p{i}" for i in range(SRV_PAIRS)]
                loads.append(list(zip(names, s1, quals, names, s2, quals)))
                origins.append(dict(zip(names, zip(ci, st1, st2))))
            timers = srv_timers()
            lines, wall = srv_clients(port, loads)
            torch.cuda.synchronize()
            plaunches = dict(kernels.LAUNCHES)
    finally:
        srv.close()
    pfrac = min(srv_pair_placement(ln, o, [f"ctg{i}"
                                           for i in range(len(chroms))])
                for ln, o in zip(lines, origins))
    pps = SRV_PAIR_CLIENTS * SRV_PAIRS / wall
    log(f"server (paired, {SRV_PAIR_CLIENTS} concurrent clients x "
        f"{SRV_PAIRS} pairs of {PAIR_LEN} bp mates): {pps:.1f} pairs/s "
        f"({wall:.2f} s, host clock); first request {pfirst:.3f} s; every "
        f"pair answered with two records; both mates at planted origin and "
        f"strand, the lowest client {pfrac:.4f}; kernel launches over the "
        f"phase {plaunches}")
    if pfrac < SRV_PAIR_ORIGIN_MIN:
        raise RuntimeError(f"server pair origin fraction {pfrac:.4f} < "
                           f"{SRV_PAIR_ORIGIN_MIN}")
    for name in ("sw_banded", "sw"):
        if plaunches[name] == 0:
            raise RuntimeError(f"the paired server never launched {name}")
    out.update(pairs_per_s=pps, pair_origin=pfrac,
               first_request_paired_s=pfirst, paired_launches=plaunches,
               paired_host=srv_breakdown("paired", timers, wall))
    log(f"phase SRV in {time.time() - t_phase:.1f} s on {card_line()}")
    return out


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree of them (`mesh.tree_map`)."""
    from bowtie2_server_tpu_torch.parallel.mesh import tree_map
    sizes = []
    tree_map(lambda t: sizes.append(t.numel() * t.element_size()), tree)
    return sum(sizes)


def run_mesh_path(idx, batches, where, label):
    """Phase 4's loop on an UnpairedAligner placed by `where` (a device or
    a mesh): batches[0] warms up, the next MESH_BATCHES run at depth DEPTH
    with the launch counters zeroed just before and read just after, the
    rest under torch.profiler. Logs and returns (the measured batches' SAM
    lines, a dict of reads/s, launches, dispatches, the host ms a dispatch
    took to enqueue, the shards that overflowed and the device shares)."""
    import torch
    from bowtie2_server_tpu_torch.align.candgen import shard_overflows
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.ops import kernels
    al = UnpairedAligner(idx, **where)
    cg = al.candgen
    n_shards = len(cg.devices)
    disp, over = [], []
    dispatch, fetch = cg.dispatch, cg.fetch

    def timed_dispatch(*a, **k):
        t0 = time.perf_counter()
        try:
            return dispatch(*a, **k)
        finally:
            disp.append((time.perf_counter() - t0) * 1e3)

    def checked_fetch(h):
        res = fetch(h)
        bad = np.nonzero(shard_overflows(res.counters, h[1]))[0]
        if len(bad):
            over.append([int(b) for b in bad])
        return res

    cg.dispatch, cg.fetch = timed_dispatch, checked_fetch
    al.align_batch(*batches[0])
    # what each distinct card holds: the index (both FM directions, the
    # packed text, run bounds) and the k-mer table, once however many
    # shards it runs
    held = {str(d): (tensor_bytes(cg._didx[d]) + sum(
        tensor_bytes(t[d]) for t, _ in cg._ktabs.values())) / 2**20
        for d in cg._didx}
    disp.clear()
    over.clear()
    measured = batches[1 : 1 + MESH_BATCHES]
    kernels.reset_launches()
    t0 = time.time()
    outs = pipelined(al.align_async, al.align_wait, measured, DEPTH)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    n_disp, disp_ms = len(disp), float(np.mean(disp))
    over_ms = list(over)
    prof = profile_device(lambda: pipelined(
        al.align_async, al.align_wait, batches[1 + MESH_BATCHES :], DEPTH))
    n = sum(len(b[0]) for b in measured)
    rps = n / dt
    log(f"MESH {label}: {rps:.1f} reads/s over {len(measured)} batches of "
        f"{len(measured[0][0])} at depth {DEPTH}; {n_disp} dispatches, "
        f"{disp_ms:.2f} ms of host time a dispatch to enqueue its "
        f"{n_shards} shard(s); sw_banded {launches['sw_banded']} launches "
        f"({launches['sw_banded'] / len(measured):.2f} a batch, "
        f"{n_shards} a dispatch); shards that overflowed their capacities: "
        f"{over_ms or 'none'}; launches {launches}; the index and k-mer "
        f"table held a card, MiB: {held}")
    if launches["sw_banded"] != n_shards * n_disp:
        raise RuntimeError(f"MESH {label}: {launches['sw_banded']} "
                           f"sw_banded launches, not one a shard and "
                           f"dispatch ({n_shards} x {n_disp})")
    for name in ("sw_banded", "sw_banded_general", "sw"):
        if launches[name] == 0:
            raise RuntimeError(f"MESH {label}: never launched {name}")
    shares = device_shares(f"MESH {label}", prof, PROFILED)
    sam = [ln for r in outs for ln in sam_lines(r, idx.ref_names)]
    return sam, dict(shards=n_shards, reads_per_s=rps, launches=launches,
                     dispatches=n_disp, dispatch_host_ms=disp_ms,
                     overflowed_shards=over_ms, index_mib=held,
                     device=shares)


def mesh_same_sam(label, got, want):
    diff = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    if diff:
        raise RuntimeError(f"MESH {label}: {diff} SAM lines differ from "
                           f"the one-card run's")
    log(f"MESH {label}: {len(got)} SAM lines identical to the one-card "
        f"run's")


def mesh_step(idx, contigs, shards):
    """make_sharded_step over `shards` logical shards, on cuda:0 against
    the CPU: best, offs and n_aligned equal; on the card it launches
    fm_walk (SEARCH) and banded_kernel<32> once a shard."""
    import torch
    from bowtie2_server_tpu_torch.ops import fm as dfm
    from bowtie2_server_tpu_torch.ops import kernels
    from bowtie2_server_tpu_torch.ops.sw import SwConfig
    from bowtie2_server_tpu_torch.parallel.mesh import (make_mesh,
                                                        make_sharded_step)
    from bowtie2_server_tpu_torch.utils import dna
    from bowtie2_server_tpu_torch.utils.scoring import Scoring
    _, seqs, quals, _ = make_reads(67, contigs, MESH_STEP_READS)
    reads = np.stack([dna.encode(s) for s in seqs]).astype(np.uint8)
    lens = np.full(len(seqs), READ_LEN, np.int32)
    sc = Scoring.default_e2e()
    mmpen = sc.mm_penalties()[np.frombuffer(b"".join(quals), np.uint8)
                              .reshape(reads.shape) - 33].astype(np.int32)
    minsc = sc.score_min_for(READ_LEN)
    host = [torch.from_numpy(a) for a in (reads, lens, mmpen)]
    got = []
    for dev in (MESH_CARD, "cpu"):
        step = make_sharded_step(make_mesh(shards, device=dev), SwConfig(),
                                 MESH_STEP_K)
        fm = dfm.to_device(idx.fw, dev)
        joined = torch.from_numpy(idx.joined).to(dev)
        kernels.reset_launches()
        got.append([t.cpu().numpy() for t in step(fm, joined, *host, minsc)])
        if len(got) == 1:
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    for k, name in enumerate(("best", "offs", "n_aligned")):
        if not np.array_equal(got[0][k], got[1][k]):
            raise RuntimeError(f"MESH make_sharded_step: {name} differs "
                               f"between CUDA and CPU")
    if launches["sw_banded"] != shards or launches["fm_walk"] != shards:
        raise RuntimeError(f"MESH make_sharded_step: launches {launches}, "
                           f"not one sw_banded and fm_walk a shard")
    log(f"MESH make_sharded_step over {shards} logical shards, "
        f"{MESH_STEP_READS} reads of {READ_LEN} bp, K = {MESH_STEP_K}: "
        f"best, offs and n_aligned ({int(got[1][2])}) equal on CUDA "
        f"and CPU; card launches {launches}")
    return launches


def phase_mesh(base, idx, contigs, pidx, chroms):
    """Phase MESH: the main path over 'dp' meshes at full width. Logical
    meshes of MESH_SHARDS shards on cuda:0 beside the one-card path on the
    same reads (SAM equal), CUDA against CPU over a mesh of 2,
    make_sharded_step on the card against the CPU, the dry runs; over
    every card and through a `--workers 1` server when the machine has
    more than one. Returns the paths line's "mesh" entry."""
    import torch
    from bowtie2_server_tpu_torch.align.pipeline import SearchPolicy
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.parallel import mesh as tmesh
    t_phase = time.time()
    names, seqs, quals, _ = make_reads(
        61, contigs, BATCH * (1 + MESH_BATCHES + PROFILED))
    batches = [(make_batch(names[i : i + BATCH], seqs[i : i + BATCH],
                           quals[i : i + BATCH]),)
               for i in range(0, len(names), BATCH)]
    one_sam, one = run_mesh_path(idx, batches, dict(device=MESH_CARD),
                                 "one card")
    out = {"one_card": one}
    for n in MESH_SHARDS:
        label = f"{n} logical shards on {MESH_CARD}"
        sam, res = run_mesh_path(
            idx, batches, dict(mesh=tmesh.make_mesh(n, device=MESH_CARD)),
            label)
        mesh_same_sam(label, sam, one_sam)
        out[f"logical_{n}"] = res
    for label, pol, reads, big in (
            ("reads", SearchPolicy(), make_reads(63, contigs, MESH_PARITY)[:3],
             None),
            ("reads of 18-60 bp", SearchPolicy(),
             make_mixed_reads(64, contigs, MESH_PARITY), None),
            ("force_big", SearchPolicy(),
             make_reads(65, contigs, MESH_PARITY)[:3], True)):
        launches, _ = parity_unpaired(f"mesh of 2 logical shards, {label}",
                                      idx, pol, *reads, force_big=big,
                                      shards=2)
        if launches["sw_banded"] < 2:
            raise RuntimeError(f"MESH parity {label}: {launches}")
    launches = phase_parity_paired(pidx, chroms, MESH_PAIRS, shards=2)
    if launches["sw"] == 0:
        raise RuntimeError("MESH parity pairs: mate rescue never launched "
                           "sw")
    out["step_launches"] = mesh_step(idx, contigs, 2)
    n_cards = torch.cuda.device_count()
    dry = (n_cards, "cuda") if n_cards >= 2 else (2, MESH_CARD)
    for name in ("dryrun_multichip", "dryrun_full_pipeline"):
        getattr(tmesh, name)(*dry)
        log(f"MESH {name}{dry}: passed")
    if n_cards >= 2:
        label = f"make_mesh() over {n_cards} cards"
        sam, res = run_mesh_path(idx, batches, dict(mesh=tmesh.make_mesh()),
                                 label)
        mesh_same_sam(label, sam, one_sam)
        out["cards"] = res
        out["server"] = mesh_server(base, contigs, n_cards)
    else:
        log("MESH: one card seen (torch.cuda.device_count() == 1): the "
            "mesh over real cards and the --workers 1 server over it were "
            "not run")
    log(f"phase MESH in {time.time() - t_phase:.1f} s on {card_line()}")
    return out


def mesh_server(base, contigs, n_cards):
    """Bt2Server(device='cuda') with --workers 1 on a machine of n_cards:
    its one worker holds a mesh over every card. A raw request with fixed
    names equals _align_pack on a one-card worker, line by line; then
    phase SRV's unpaired clients load it."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_serving import serving
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.ops import kernels
    from bowtie2_server_tpu_torch.server.bt2srv import Bt2Server
    srv = Bt2Server(str(base), device="cuda")
    try:
        if srv.up.mesh is None or srv.up.mesh.size != n_cards:
            raise RuntimeError(f"server --workers 1 on {n_cards} cards: "
                               f"its worker holds {srv.up.mesh}")
        with serving(srv) as port:
            names, seqs, quals = make_mixed_reads(66, contigs, SRV_EXACT,
                                                  lo=18, hi=100)
            rows = [(n, s, q, None, None, None)
                    for n, s, q in zip(names, seqs, quals)]
            pal = PairedAligner(srv.idx, device=MESH_CARD)
            first = srv_exact(srv, port, rows, (pal.up, pal),
                              f"a mesh of {n_cards} cards against one card")
            loads = []
            for c in range(SRV_CLIENTS):
                _, seqs, quals, _ = make_reads(90 + c, contigs, SRV_READS)
                loads.append(list(zip(
                    [f"c{c}r{i}" for i in range(SRV_READS)], seqs, quals)))
            kernels.reset_launches()
            lines, wall = srv_clients(port, loads)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    finally:
        srv.close()
    if any(len(ln) != SRV_READS for ln in lines):
        raise RuntimeError("MESH server: a read without its one record")
    rps = SRV_CLIENTS * SRV_READS / wall
    log(f"MESH server --workers 1 over {n_cards} cards ({srv.up.mesh}): "
        f"{rps:.1f} reads/s from {SRV_CLIENTS} clients x {SRV_READS} reads "
        f"({wall:.2f} s, host clock); first request {first:.3f} s; "
        f"launches {launches}")
    return dict(reads_per_s=rps, first_request_s=first, launches=launches)


@contextlib.contextmanager
def first_calls(module, names, when=lambda name, args: True):
    """{name: (args, kwargs)} of the first call of each of `module`'s
    functions `names` made while the block runs for which when(name, args)
    holds (the calls go through)."""
    got, origs = {}, {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*a, **k):
            if name not in got and when(name, a):
                got[name] = (a, k)
            return fn(*a, **k)
        return call

    for name, fn in origs.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield got
    finally:
        for name, fn in origs.items():
            setattr(module, name, fn)


# the FM functions whose inputs phase FM takes from the short-read batch
FM_CALLS = ("backward_search_record_body", "backward_search_body", "lf_step",
            "one_mm_phase1_body")


def run_short_path(idx, contigs, device, batch, n_batches, seed=31):
    """The short-read path: one warm-up batch of SR_LEN-base reads (the
    inputs of its first FM calls captured), then n_batches at dispatch
    depth DEPTH, then PROFILED batches under torch.profiler. Returns
    (reads/s, aligned fraction, origin fraction, warm-up seconds, the
    profile, the captured calls)."""
    import torch
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.ops import fm as dfm
    names, seqs, quals, origin = make_reads(
        seed, contigs, batch * (n_batches + 1 + PROFILED), read_len=SR_LEN,
        max_subs=2)
    batches = [(make_batch(names[i : i + batch], seqs[i : i + batch],
                           quals[i : i + batch]),)
               for i in range(0, len(names), batch)]
    al = UnpairedAligner(idx, device=device)
    t0 = time.time()
    with first_calls(dfm, FM_CALLS) as cap:
        outs = [al.align_batch(*batches[0])]
    warm = time.time() - t0
    t0 = time.time()
    outs += pipelined(al.align_async, al.align_wait,
                      batches[1 : n_batches + 1], DEPTH)
    torch.cuda.synchronize()
    dt = time.time() - t0
    prof = profile_device(lambda: pipelined(
        al.align_async, al.align_wait, batches[n_batches + 1 :], DEPTH))
    n = batch * n_batches
    aligned = sum(r.n_aligned() for r in outs[1:]) / n
    frac = np.mean([origin_fraction(r, tuple(o[i * batch : (i + 1) * batch]
                                             for o in origin), False, SR_LEN)
                    for i, r in enumerate(outs)])
    return n / dt, aligned, float(frac), warm, prof, cap


def phase_short(idx, contigs):
    """Phase SR: the general short-read shape at full width on the main
    path's genome, its fw and mirror FM directions on the card."""
    import torch
    from bowtie2_server_tpu_torch.ops import kernels
    kernels.reset_launches()
    rps, aligned, frac, warm, prof, cap = run_short_path(
        idx, contigs, "cuda", BATCH, SR_BATCHES)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_all = 1 + SR_BATCHES + PROFILED
    log(f"short-read path ({SR_LEN} bp, e2e): {rps:.1f} reads/s over "
        f"{SR_BATCHES} batches of {BATCH} at depth {DEPTH} (warm-up batch "
        f"{warm:.2f} s); aligned {aligned:.4f}; at planted origin and strand "
        f"{frac:.4f}; kernel launches over all {n_all} batches {launches}; "
        f"fm_walk {launches['fm_walk'] / n_all:.2f} a batch")
    shares = device_shares(f"short-read path ({SR_LEN} bp)", prof, PROFILED)
    if frac < ORIGIN_MIN_SR:
        raise RuntimeError(f"short-read origin fraction {frac:.4f} < "
                           f"{ORIGIN_MIN_SR}")
    for name in ("fm_walk", "fm_lf_step", "sw_banded"):
        if launches[name] == 0:
            raise RuntimeError(f"the short-read path never launched {name}")
    return launches, dict(reads_per_s=rps, aligned=aligned, origin=frac,
                          device=shares), cap


def phase_n1(idx, contigs, n=BATCH, seed=32):
    """One -N 1 batch of n reads of N1_LEN bases (the inputs of the first
    recorded pass over its seeds captured), timed (host clock,
    synchronised)."""
    import torch
    from bowtie2_server_tpu_torch.align.pipeline import (SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.ops import fm as dfm
    from bowtie2_server_tpu_torch.ops import kernels
    names, seqs, quals, origin = make_reads(seed, contigs, n,
                                            read_len=N1_LEN)
    al = UnpairedAligner(idx, policy=SearchPolicy(n_seed_mms=1),
                         device="cuda")
    batch = make_batch(names, seqs, quals)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    # the seeds' pass: patterns narrower than the reads' rows
    with first_calls(dfm, ("backward_search_record_body",),
                     lambda _, a: a[1].shape[1] < N1_LEN) as cap:
        recs = al.align_batch(batch)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    frac = origin_fraction(recs, origin, False, N1_LEN)
    log(f"-N 1 batch: {n} reads of {N1_LEN} bp in {dt:.3f} s ({n / dt:.1f} "
        f"reads/s); at planted origin and strand {frac:.4f}; kernel launches "
        f"{launches}")
    if frac < ORIGIN_MIN_N1:
        raise RuntimeError(f"-N 1 origin fraction {frac:.4f} < "
                           f"{ORIGIN_MIN_N1}")
    if launches["fm_walk"] == 0 or launches["fm_lf_step"] == 0:
        raise RuntimeError("the -N 1 batch never launched the FM kernels")
    # the batch's first dispatch (capacities at 1x) once more, on a fresh
    # aligner: its counters against the sets they must fit
    al = UnpairedAligner(idx, policy=SearchPolicy(n_seed_mms=1),
                         device="cuda")
    h = al.collect_async(batch)[4]
    ctr, cfg = al.candgen.fetch(h).counters[0], h[1]
    sets = dict(candidates=(ctr[0], cfg.C_max), elements=(ctr[1], cfg.C_pre),
                branches_fw=(ctr[2], cfg.k1), branches_mirror=(ctr[3], cfg.k1),
                hit_ranges=(ctr[4], cfg.NH))
    log("-N 1 batch at 1x: " + ", ".join(
        f"{k} {int(v)} of {int(c)}" for k, (v, c) in sets.items()))
    return dict(reads_per_s=n / dt, seconds=dt, origin=frac,
                sets_at_1x={k: [int(v), int(c)] for k, (v, c) in
                            sets.items()}), cap


def phase_fm_kernels(idx, sr_cap, n1_cap, ceiling):
    """fm_walk and fm_lf_step against their plain torch versions on the
    inputs the paths gave them: the short-read batch's recorded fw pass
    (2 x 32768 lanes, 64 steps), its ftab seed search, its 1-mismatch
    continuation and its phase-0 branch grid, and an ftab search over the
    -N 1 batch's seeds; exact on
    the edge tiles of tests/torch_tiles.py over both directions of the
    genome; the time of one dependent step. Returns the two kernels'
    entries of the kernels line."""
    import torch
    from bowtie2_server_tpu_torch.ops import fm as dfm
    from bowtie2_server_tpu_torch.ops import kernels
    from bowtie2_server_tpu_torch.scripts import bench_fm
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_tiles import fm_edge_tile
    fw = sr_cap["backward_search_record_body"][0][0]
    lat = bench_fm.step_latency_ms(fw, idx.joined)
    side_bytes = lambda f: f.side.numel() * 4
    log(f"fm_walk: one dependent LF step {lat * 1e3:.3f} us (a warp of "
        f"lanes walking 2048 characters)")
    shapes = []

    def add(shape, run, lanes_steps, bnd):
        """One shape's entry from its hold() run, the LF steps of each
        lane and its bound function of (steps, lanes)."""
        steps, P = int(lanes_steps.sum()), int(lanes_steps.shape[0])
        r = summary([run], bnd(steps, P))
        floor = int(lanes_steps.max()) * lat
        shapes.append(dict(r, shape=shape, lanes=P, lf_steps=steps,
                           chain_floor_ms=floor))
        log(f"  {shape}: {steps} LF steps in {P} lanes; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['frac_of_bound']:.4f} of it; dependent-chain floor "
            f"{floor:.4f} ms ({int(lanes_steps.max())} steps)")

    (fm, pat, lens), _ = sr_cap["backward_search_record_body"]
    P, L = pat.shape
    run = hold(f"fm_walk record (short-read stage 1): {P} lanes x {L} steps",
               None, lambda _: dfm.backward_search_record_body(fm, pat, lens),
               lambda _: dfm.backward_search_record_body_torch(fm, pat,
                                                               lens),
               "fm_walk_kernel")
    rec = dfm.backward_search_record_body(fm, pat, lens)
    add("record_sr", run, bench_fm.walk_steps(pat, lens, *rec),
        lambda st, p: bench_fm.walk_bound(st, p, L, "record", ceiling,
                                          side_bytes(fm), pat.numel()))

    # the ftab seed search the short-read batch ran, and one over the -N 1
    # batch's seeds (whose exact ranges that path takes from their
    # recorded pass)
    (fm, pat, lens, *rest), kw = sr_cap["backward_search_body"]
    searches = [("ftab_search_sr", fm, pat, lens,
                 kw.get("use_ftab", rest[0] if rest else True))]
    (fm, pat, lens), _ = n1_cap["backward_search_record_body"]
    searches.append(("ftab_search_n1", fm, pat, lens, True))
    for shape, fm, pat, lens, use_ftab in searches:
        P, L = pat.shape
        run = hold(f"fm_walk ftab search ({shape}): {P} lanes x {L}", None,
                   lambda _: dfm.backward_search_body(fm, pat, lens,
                                                      use_ftab),
                   lambda _: dfm.backward_search_body_torch(fm, pat, lens,
                                                            use_ftab),
                   "fm_walk_kernel")
        rec = dfm.backward_search_record_body(fm, pat, lens)
        per = bench_fm.walk_steps(pat, lens, *rec, use_ftab=use_ftab)
        n_ftab = (int(bench_fm.ftab_lanes(pat, lens).sum()) if use_ftab
                  else 0)
        add(shape, run, per,
            lambda st, p: bench_fm.walk_bound(st, p, L, "search", ceiling,
                                              side_bytes(fm), pat.numel(),
                                              ftab_lanes=n_ftab))

    (fm, pat, cb, pos, top, bot, n_steps), _ = sr_cap["one_mm_phase1_body"]
    run = hold(f"fm_walk continuation (short-read 1mm): {cb.shape[0]} lanes "
               f"x {n_steps}", None,
               lambda _: dfm.one_mm_phase1_body(fm, pat, cb, pos, top, bot,
                                                n_steps),
               lambda _: dfm.one_mm_phase1_body_torch(fm, pat, cb, pos, top,
                                                      bot, n_steps),
               "fm_walk_kernel")
    pos_out = dfm.one_mm_phase1_body(fm, pat, cb, pos, top, bot, n_steps)[0]
    add("continuation_sr", run, (pos - pos_out).to(torch.int64),
        lambda st, p: bench_fm.walk_bound(st, p, n_steps, "cont", ceiling,
                                          side_bytes(fm), pat.numel()))

    (fm, c, top, bot), _ = sr_cap["lf_step"]
    run = hold(f"fm_lf_step (short-read phase-0 grid): {c.shape[0]} lanes",
               None, lambda _: dfm.lf_step(fm, c, top, bot),
               lambda _: dfm.lf_step_torch(fm, c, top, bot),
               "fm_lf_step_kernel")
    lf = dict(summary([run], bench_fm.lf_step_bound(c, top, bot, ceiling,
                                                    side_bytes(fm))),
              lanes=int(c.shape[0]),
              lf_steps=int(((c <= 3) & (top < bot)).sum()))

    # exact on the edge tiles, both directions of the genome
    edge_err = 0
    for name, text in (("fw", idx.joined), ("mirror", idx.joined[::-1])):
        d = getattr(idx, name)
        dev_fm = dfm.to_device(d, "cuda")
        tile = [torch.from_numpy(a).cuda()
                for a in fm_edge_tile(9, text, d.n, d.primary)]
        tpat, tlens, tc, ttop, tbot = tile
        lanes = torch.arange(tlens.shape[0], dtype=torch.int32,
                             device="cuda")
        calls = [
            (dfm.lf_step, dfm.lf_step_torch, (tc, ttop, tbot)),
            (dfm.backward_search_record_body,
             dfm.backward_search_record_body_torch, (tpat, tlens)),
            (dfm.one_mm_phase1_body, dfm.one_mm_phase1_body_torch,
             (tpat, lanes, tlens - 1, ttop, tbot, 48))]
        calls += [(lambda f, *a, u=u: dfm.backward_search_body(f, *a, u),
                   lambda f, *a, u=u: dfm.backward_search_body_torch(f, *a,
                                                                     u),
                   (tpat, tlens)) for u in (False, True)]
        for kern, plain, args in calls:
            got, want = kern(dev_fm, *args), plain(dev_fm, *args)
            edge_err = max([edge_err] + [int((g - w).abs().max())
                                         for g, w in zip(got, want)])
    log(f"fm_walk and fm_lf_step on the edge tiles (fw and mirror): "
        f"max_abs_err={edge_err}")
    main = shapes[0]
    walk = dict({k: main[k] for k in ("ms", "event_ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "frac_of_bound", "chain_floor_ms")},
                max_abs_err=max([edge_err] + [s["max_abs_err"]
                                              for s in shapes]),
                step_latency_ms=lat, shapes=shapes)
    lf["max_abs_err"] = max(lf["max_abs_err"], edge_err)
    n, mix = kernels.loop_mix("fm_walk_kernel")
    walk["loop_sass_instructions"] = n
    log(f"fm_walk largest loop (SASS): {n} instructions {mix}")
    out = {"fm_walk": walk, "fm_lf_step": lf}
    for name, r in out.items():
        log(f"{name}: {r['ms']:.4f} ms against a bound of "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['frac_of_bound']:.4f} of it")
        if r["max_abs_err"] != 0:
            raise RuntimeError(f"{name}: kernel disagrees with its plain "
                               f"version (max_abs_err {r['max_abs_err']})")
    return out


def run_big_path(idx, contigs, device, batch, n_batches, seed=51,
                 profiled=PROFILED):
    """The big-index path forced on idx: one warm-up batch of READ_LEN-base
    reads (the inputs of its first walk-left and recorded pass captured),
    then n_batches at dispatch depth DEPTH, then `profiled` batches under
    torch.profiler (card only). Returns (reads/s, aligned fraction, origin
    fraction, warm-up seconds, the profile or None, the captured calls,
    the (reads, size multiple) of every dispatch)."""
    import torch
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.ops import fm as dfm
    names, seqs, quals, origin = make_reads(
        seed, contigs, batch * (n_batches + 1 + profiled))
    batches = [(make_batch(names[i : i + batch], seqs[i : i + batch],
                           quals[i : i + batch]),)
               for i in range(0, len(names), batch)]
    al = UnpairedAligner(idx, device=device, force_big=True)
    if not (al.big and al.dev.big and al.candgen.big):
        raise RuntimeError("force_big did not give the big layout")
    dispatches = []
    dispatch = al.candgen.dispatch

    def counted(seqs_, *a, size_mult=1, **k):
        # the size multiple in effect: the sticky escalation's at least
        dispatches.append((seqs_.shape[0],
                           max(size_mult, al.candgen._sticky)))
        return dispatch(seqs_, *a, size_mult=size_mult, **k)

    al.candgen.dispatch = counted
    sync = torch.cuda.synchronize if device == "cuda" else lambda: None
    t0 = time.time()
    with first_calls(dfm, ("resolve_rows_body",
                           "backward_search_record_body")) as cap:
        outs = [al.align_batch(*batches[0])]
    warm = time.time() - t0
    t0 = time.time()
    outs += pipelined(al.align_async, al.align_wait,
                      batches[1 : n_batches + 1], DEPTH)
    sync()
    dt = time.time() - t0
    prof = (profile_device(lambda: pipelined(
        al.align_async, al.align_wait, batches[n_batches + 1 :], DEPTH))
        if profiled else None)
    n = batch * n_batches
    aligned = sum(r.n_aligned() for r in outs[1:]) / n
    frac = np.mean([origin_fraction(r, tuple(o[i * batch : (i + 1) * batch]
                                             for o in origin), False)
                    for i, r in enumerate(outs)])
    return n / dt, aligned, float(frac), warm, prof, cap, dispatches


def phase_big(idx, contigs):
    """Phase BIG: the big-index path at full width on the main path's
    genome."""
    import torch
    from bowtie2_server_tpu_torch.ops import kernels
    kernels.reset_launches()
    rps, aligned, frac, warm, prof, cap, disp = run_big_path(
        idx, contigs, "cuda", BATCH, BIG_BATCHES)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_all = 1 + BIG_BATCHES + PROFILED
    mults = {m: sum(1 for _, mm in disp if mm == m)
             for m in sorted({m for _, m in disp})}
    halved = sum(1 for b, _ in disp if b < BATCH)
    log(f"big-index path (forced, {READ_LEN} bp, e2e): {rps:.1f} reads/s "
        f"over {BIG_BATCHES} batches of {BATCH} at depth {DEPTH} (warm-up "
        f"batch {warm:.2f} s); aligned {aligned:.4f}; at planted origin and "
        f"strand {frac:.4f}; {len(disp)} dispatches for {n_all} batches "
        f"(by size multiple {mults}; {halved} of a halved batch); kernel "
        f"launches over all {n_all} batches {launches}")
    shares = device_shares("big-index path", prof, PROFILED)
    if frac < ORIGIN_MIN_BIG:
        raise RuntimeError(f"big-index origin fraction {frac:.4f} < "
                           f"{ORIGIN_MIN_BIG}")
    for name in ("fm_resolve", "fm_walk", "sw_banded"):
        if launches[name] == 0:
            raise RuntimeError(f"the big-index path never launched {name}")
    return launches, dict(reads_per_s=rps, aligned=aligned, origin=frac,
                          dispatches=len(disp), batches=n_all,
                          dispatches_by_size_mult=mults,
                          halved_dispatches=halved, device=shares), cap


def phase_big_kernels(idx, big_cap, ceiling, lat):
    """fm_resolve against its plain torch version on the inputs the big
    batch gave it and on an edge tile of rows over both directions, with
    its bound and dependent-chain floor (lat: phase FM's dependent step,
    ms); the uint32 fm_walk against its plain version on the big batch's
    recorded pass. Returns (fm_resolve's entry of the kernels line, the
    uint32 walk's entry)."""
    import torch
    from bowtie2_server_tpu_torch.ops import fm as dfm
    from bowtie2_server_tpu_torch.scripts import bench_fm
    (fm, rows, valid), _ = big_cap["resolve_rows_body"]
    P = rows.shape[0]
    run = hold(f"fm_resolve (big batch, fw): {P} lanes "
               f"({int(valid.sum())} valid)", None,
               lambda _: dfm.resolve_rows_body(fm, rows, valid),
               lambda _: dfm.resolve_rows_body_torch(fm, rows, valid),
               "fm_resolve_kernel")
    steps = bench_fm.resolve_steps(fm, rows, valid)
    table = (fm.side.numel() + fm.mark.numel()) * 4
    res = summary([run], bench_fm.resolve_bound(steps, valid, ceiling,
                                                table))
    res.update(lanes=P, valid=int(valid.sum()), lf_steps=int(steps.sum()),
               max_steps=int(steps.max()),
               chain_floor_ms=int(steps.max()) * lat)
    log(f"  fm_resolve: {res['lf_steps']} LF steps in {res['valid']} valid "
        f"lanes (at most {res['max_steps']}); bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), {res['frac_of_bound']:.4f} of it; "
        f"dependent-chain floor {res['chain_floor_ms']:.4f} ms")
    # exact on an edge tile: the first blocks' rows (rows marked at step 0
    # among them), the primary row, row 0, the last row, random rows, a
    # tenth invalid, in both directions
    edge_err = 0
    rng = np.random.default_rng(53)
    for name in ("fw", "mirror"):
        d = getattr(idx, name)
        dev_fm = dfm.to_device(d, "cuda", big=True)
        r = np.concatenate([np.arange(200), [d.primary, 0, d.n - 1],
                            rng.integers(0, d.n, 4000)]).astype(np.int32)
        v = rng.random(len(r)) < 0.9
        v[:203] = True
        tr, tv = torch.from_numpy(r).cuda(), torch.from_numpy(v).cuda()
        got = dfm.resolve_rows_body(dev_fm, tr, tv)
        want = dfm.resolve_rows_body_torch(dev_fm, tr, tv)
        sa = torch.from_numpy(d.sa[r].astype(np.int64)).cuda()
        edge_err = max(edge_err, int((got - want).abs().max()),
                       int((dfm.widen(got) - sa)[tv].abs().max()))
    log(f"fm_resolve on the edge tiles (fw and mirror, against the plain "
        f"version and the full SA): max_abs_err={edge_err}")
    res["max_abs_err"] = max(res["max_abs_err"], edge_err)
    # the uint32 instantiation of fm_walk on the big batch's recorded pass
    (fm, pat, lens), _ = big_cap["backward_search_record_body"]
    if not fm.big:
        raise RuntimeError("the captured recorded pass is not a big index's")
    Pw, L = pat.shape
    run = hold(f"fm_walk uint32 record (big batch): {Pw} lanes x {L} steps",
               None, lambda _: dfm.backward_search_record_body(fm, pat,
                                                               lens),
               lambda _: dfm.backward_search_record_body_torch(fm, pat,
                                                               lens),
               "fm_walk_kernel")
    rec = dfm.backward_search_record_body(fm, pat, lens)
    per = bench_fm.walk_steps(pat, lens, *map(dfm.widen, rec))
    walk = summary([run], bench_fm.walk_bound(
        int(per.sum()), Pw, L, "record", ceiling, fm.side.numel() * 4,
        pat.numel()))
    walk.update(lanes=Pw, lf_steps=int(per.sum()),
                chain_floor_ms=int(per.max()) * lat)
    log(f"  fm_walk uint32: bound {walk['bound_ms']:.4f} ms "
        f"({walk['bound_by']}), {walk['frac_of_bound']:.4f} of it; "
        f"dependent-chain floor {walk['chain_floor_ms']:.4f} ms")
    for name, r in (("fm_resolve", res), ("fm_walk (uint32)", walk)):
        if r["max_abs_err"] != 0:
            raise RuntimeError(f"{name}: kernel disagrees with its plain "
                               f"version (max_abs_err {r['max_abs_err']})")
    return res, walk


def phase_hbm(ceiling):
    """fm_walk (every mode, both row types) and fm_resolve against their
    plain torch versions on tables far past the 50 MB L2, laid out on the
    card by the layout's own rules (scripts/bench_fm.py random_fm), with
    patterns read off them by LF walks (walk_patterns), so that every
    walk runs its full length; each timed against its HBM bound (the
    gather probe's random-read rates) and its chain floor at the HBM step
    latency. Returns the kernels line's entries {kernel: {shape: ...}}."""
    import torch
    from bowtie2_server_tpu_torch.ops import fm as dfm
    from bowtie2_server_tpu_torch.scripts import bench_fm
    t_phase = time.time()
    rates = bench_fm.gather_rates(torch.device("cuda"))
    log(f"gather probe (2 GB table): {rates[32]:.4g} random 32-byte and "
        f"{rates[64]:.4g} random 64-byte reads/s ({rates[32] * 32 / 1e12:.3f}"
        f" and {rates[64] * 64 / 1e12:.3f} TB/s)")
    out = {"fm_walk": {"gather_reads_per_s": rates},
           "fm_resolve": {"gather_reads_per_s": rates}}
    err = 0
    for (n, big), seed in zip(HBM_TABLES, (61, 62)):
        tag = "uint32" if big else "int32"
        t0 = time.time()
        fm = bench_fm.random_fm(n, "cuda", seed=seed, big=big)
        torch.cuda.synchronize()
        log(f"HBM table ({tag} rows): {n} rows, {bench_fm.table_bytes(fm) / 1e9:.3f} "
            f"GB of sides{' and marks' if big else ''}, built on the card in "
            f"{time.time() - t0:.1f} s")
        rng = np.random.default_rng(seed)
        cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()

        def rows_of(k):
            # random rows; of a big table half past 2^31
            r = rng.integers(0, n, k)
            if big:
                r[: k // 2] = rng.integers(min(1 << 31, n // 2), n, k // 2)
            return cuda(r.astype(np.int64))

        lat = bench_fm.step_latency_ms(
            fm, pat=bench_fm.walk_patterns(fm, rows_of(32), 2048))
        log(f"  one dependent LF step on it: {lat * 1e3:.3f} us")
        P, L = HBM_RECORD
        pat = bench_fm.walk_patterns(fm, rows_of(P), L)
        lens_h = rng.integers(L // 2, L + 1, P)
        lens_h[:6] = (0, 1, 9, 10, 11, L)
        lens = cuda(lens_h.astype(np.int32))
        shapes = {}

        def add(shape, run, per_lane, blocks, mode, n_steps, pat_bytes,
                n_ftab=0):
            steps, lanes = int(per_lane.sum()), int(per_lane.shape[0])
            r = summary([run], bench_fm.walk_bound_hbm(
                blocks, steps, lanes, n_steps, mode, ceiling, rates[32],
                pat_bytes, ftab_lanes=n_ftab))
            r.update(lanes=lanes, lf_steps=steps, dram_blocks=blocks,
                     chain_floor_ms=int(per_lane.max()) * lat)
            shapes[shape] = r
            log(f"  {shape}: {steps} LF steps reading {blocks} distinct "
                f"blocks in {lanes} lanes; HBM bound "
                f"{r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['frac_of_bound']:.4f} of it; chain "
                f"floor {r['chain_floor_ms']:.4f} ms")

        run = hold(f"fm_walk {tag} record (HBM): {P} lanes x {L} steps", None,
                   lambda _: dfm.backward_search_record_body(fm, pat, lens),
                   lambda _: dfm.backward_search_record_body_torch(fm, pat,
                                                                   lens),
                   "fm_walk_kernel")
        rec = dfm.backward_search_record_body(fm, pat, lens)
        add("record", run, bench_fm.walk_steps(pat, lens,
                                               *map(dfm.widen, rec)),
            bench_fm.walk_blocks(pat, lens, *rec), "record", L, pat.numel())
        # seeds: 22 characters, some shorter than the ftab's 10, 1% with
        # an N; with and without the ftab jump
        Ps, Ls = HBM_SEEDS
        spat = bench_fm.walk_patterns(fm, rows_of(Ps), Ls)
        nmask = rng.random(Ps) < 0.01
        spat[cuda(np.flatnonzero(nmask)),
             cuda(rng.integers(0, Ls, int(nmask.sum())))] = 4
        slens = cuda(np.where(rng.random(Ps) < 0.05, rng.integers(0, 10, Ps),
                              Ls).astype(np.int32))
        srec = dfm.backward_search_record_body(fm, spat, slens)
        for use_ftab in (True, False):
            run = hold(f"fm_walk {tag} search, ftab {use_ftab} (HBM): {Ps} "
                       f"lanes x {Ls}", None,
                       lambda _: dfm.backward_search_body(fm, spat, slens,
                                                          use_ftab),
                       lambda _: dfm.backward_search_body_torch(
                           fm, spat, slens, use_ftab), "fm_walk_kernel")
            add(f"search_ftab_{use_ftab}".lower(), run, bench_fm.walk_steps(
                spat, slens, *map(dfm.widen, srec), use_ftab=use_ftab),
                bench_fm.walk_blocks(spat, slens, *srec, use_ftab=use_ftab),
                "search", Ls, spat.numel(),
                int(bench_fm.ftab_lanes(spat, slens).sum()) if use_ftab
                else 0)
        # continuations from the recorded pass's ranges part-way along
        Pc = HBM_CONT
        cb_h = rng.integers(0, P, Pc)
        pos_h = (rng.random(Pc) * np.maximum(lens_h[cb_h], 1)).astype(
            np.int64) - 1
        cb, pos = cuda(cb_h.astype(np.int32)), cuda(pos_h.astype(np.int32))
        at = (lens.to(torch.int64)[cb.long()] - 1 - pos.long()).clamp(0, L)
        top, bot = rec[0][at, cb.long()], rec[1][at, cb.long()]
        run = hold(f"fm_walk {tag} continuation (HBM): {Pc} lanes x {L}",
                   None, lambda _: dfm.one_mm_phase1_body(fm, pat, cb, pos,
                                                          top, bot, L),
                   lambda _: dfm.one_mm_phase1_body_torch(fm, pat, cb, pos,
                                                          top, bot, L),
                   "fm_walk_kernel")
        add("continuation", run, *bench_fm.cont_work(fm, pat, cb, pos, top,
                                                     bot, L),
            "cont", L, pat.numel())
        # one LF step (fm_lf_step, on the same tables) from the record's
        # ranges, with N and pad characters among them
        Pl = 1 << 20
        li = cuda(rng.integers(0, P, Pl))
        ls = cuda(rng.integers(0, L + 1, Pl))
        lc = cuda(rng.integers(0, 6, Pl).astype(np.int32))
        ltop, lbot = rec[0][ls, li], rec[1][ls, li]
        run = hold(f"fm_lf_step {tag} (HBM): {Pl} lanes", None,
                   lambda _: dfm.lf_step(fm, lc, ltop, lbot),
                   lambda _: dfm.lf_step_torch(fm, lc, ltop, lbot),
                   "fm_lf_step_kernel")
        err = max(err, run[0])
        out["fm_walk"][tag] = shapes
        err = max([err] + [r["max_abs_err"] for r in shapes.values()])
        del rec, srec, pat, spat
        if big:
            Pr = HBM_RESOLVE
            r = rows_of(Pr)
            r[:203] = cuda(np.concatenate([np.arange(200),
                                           [fm.primary, 0, n - 1]]))
            rows = dfm.narrow(r)
            valid = cuda(rng.random(Pr) < 0.9)
            run = hold(f"fm_resolve (HBM): {Pr} lanes "
                       f"({int(valid.sum())} valid)", None,
                       lambda _: dfm.resolve_rows_body(fm, rows, valid),
                       lambda _: dfm.resolve_rows_body_torch(fm, rows,
                                                             valid),
                       "fm_resolve_kernel")
            off, steps = dfm.walk_left_torch(fm, rows, valid)
            steps = torch.where(valid, steps, 0)
            nbl = bench_fm.resolve_blocks(fm, rows, valid)
            res = summary([run], bench_fm.resolve_bound_hbm(
                nbl, steps, valid, ceiling, rates[32]))
            res.update(lanes=Pr, valid=int(valid.sum()), dram_blocks=nbl,
                       lf_steps=int(steps.sum()), max_steps=int(steps.max()),
                       exhausted=int((valid & (off == 0)).sum()),
                       chain_floor_ms=int(steps.max()) * lat)
            log(f"  fm_resolve: {res['lf_steps']} LF steps ({nbl} distinct "
                f"blocks) in {res['valid']} valid lanes ({res['exhausted']} "
                f"unmarked "
                f"within 16 trips); HBM bound {res['bound_ms']:.4f} ms "
                f"({res['bound_by']}), {res['frac_of_bound']:.4f} of it; "
                f"chain floor {res['chain_floor_ms']:.4f} ms")
            out["fm_resolve"]["uint32"] = res
            err = max(err, res["max_abs_err"])
        del fm
        torch.cuda.empty_cache()
    log(f"fm_walk, fm_lf_step and fm_resolve on the HBM tables: "
        f"max_abs_err={err}; phase HBM in {time.time() - t_phase:.1f} s")
    if err != 0:
        raise RuntimeError(f"an FM kernel disagrees with its plain version "
                           f"on the HBM tables (max_abs_err {err})")
    return out


def sam_lines(recs, ref_names):
    """SAM lines of a batch's records: a lazy record view or, from the host
    path and under -k/-a, a list (secondary records after their
    primary)."""
    from bowtie2_server_tpu_torch.io.sam import sam_record
    items = recs if isinstance(recs, list) else [recs[i]
                                                for i in range(len(recs))]
    return [sam_record(r, ref_names) for r in items]


def placed(dev: str, shards=None) -> dict:
    """An aligner's placement: the device `dev` ('cuda' or 'cpu') or, with
    `shards`, a 'dp' mesh of that many logical shards on it (cuda:0 for
    the card)."""
    if shards is None:
        return dict(device=dev)
    from bowtie2_server_tpu_torch.parallel.mesh import make_mesh
    return dict(mesh=make_mesh(shards, device=MESH_CARD if dev == "cuda"
                               else dev))


def parity_unpaired(label, idx, pol, names, seqs, quals, results=True,
                    force_big=None, shards=None):
    """One batch through UnpairedAligner on the card and on the CPU (with
    `shards`, over a mesh of that many logical shards on each), which
    must give identical SAM lines and, with `results`, identical decoded
    batch results of the fused pipeline. Returns (the card run's kernel
    launches, its SAM lines)."""
    import torch
    from bowtie2_server_tpu_torch.align.candgen import BatchResult
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.ops import kernels
    sams, res = {}, {}
    for dev in ("cuda", "cpu"):
        al = UnpairedAligner(idx, policy=pol, force_big=force_big,
                             **placed(dev, shards))
        batch = make_batch(names, seqs, quals)
        if results:
            res[dev] = al.collect(batch).res
        kernels.reset_launches()
        recs = al.align_batch(batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        sams[dev] = sam_lines(recs, idx.ref_names)
    for name in BatchResult.__slots__ if results else ():
        a, b = getattr(res["cuda"], name), getattr(res["cpu"], name)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b)
        if not same:
            raise RuntimeError(f"{label}: CUDA and CPU differ in "
                               f"BatchResult.{name}")
    diff = sum(a != b for a, b in zip(sams["cuda"], sams["cpu"]))
    if diff or len(sams["cuda"]) != len(sams["cpu"]):
        raise RuntimeError(f"{label}: {diff} SAM lines differ between CUDA "
                           f"and CPU ({len(sams['cuda'])} and "
                           f"{len(sams['cpu'])} lines)")
    log(f"CUDA vs CPU, {label}: {len(names)} reads, "
        f"{'BatchResult fields and ' if results else ''}"
        f"{len(sams['cuda'])} SAM lines identical; card launches {launches}")
    return launches, sams["cuda"]


def phase_parity(idx, contigs, n=2048):
    from bowtie2_server_tpu_torch.align.pipeline import SearchPolicy
    names, seqs, quals, _ = make_reads(13, contigs, n)
    return parity_unpaired("main path", idx, SearchPolicy(), names, seqs,
                           quals)[1]


def phase_parity_short(idx, contigs, n=2048):
    """The general short-read shape, CUDA against CPU: reads of 18-60 bp,
    and 100 bp reads under -N 1."""
    from bowtie2_server_tpu_torch.align.pipeline import SearchPolicy
    for label, pol, reads in (
            ("reads of 18-60 bp", SearchPolicy(),
             make_mixed_reads(16, contigs, n)),
            ("-N 1", SearchPolicy(n_seed_mms=1),
             make_reads(17, contigs, n)[:3])):
        launches, _ = parity_unpaired(label, idx, pol, *reads)
        if launches["fm_walk"] == 0:
            raise RuntimeError(f"{label}: the card run never launched "
                               f"fm_walk")


def make_repeat_genome(seed: int, chrom_len=500_000, unit_len=100,
                       copies=300):
    """tests/test_large_k.py's shape scaled up: a random chromosome and a
    chromosome of a unit_len-base unit planted `copies` times between
    random 50-base spacers. Returns (FASTA text, chromosome codes, unit
    codes)."""
    rng = np.random.default_rng(seed)
    chrom = rng.integers(0, 4, chrom_len).astype(np.uint8)
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    rep = np.concatenate([np.concatenate([rng.integers(0, 4, 50), unit])
                          for _ in range(copies)]).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fa = (f">chr\n{bases[chrom].tobytes().decode()}\n"
          f">rep\n{bases[rep].tobytes().decode()}\n")
    return fa, chrom, unit


def phase_parity_host(n=256, n_unit=16):
    """The host path, CUDA against CPU: n reads (n_unit of them copies of
    a unit planted 300 times, some with a substitution) under -k 2000 and
    -a, and an index of the same genome without its mirror direction."""
    from bowtie2_server_tpu_torch.align.pipeline import (ALL_HITS,
                                                         SearchPolicy)
    from bowtie2_server_tpu_torch.index.build import build_index
    fa, chrom, unit = make_repeat_genome(44)
    names, seqs, quals, _ = make_reads(18, [chrom], n - n_unit)
    rng = np.random.default_rng(19)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for k in range(n_unit):
        u = unit.copy()
        if k % 2:
            u[rng.integers(0, len(u))] ^= 1
        names.append(f"u{k}")
        seqs.append(bases[u].tobytes())
        quals.append(b"I" * len(u))
    full = build_index(fa)
    for label, khits in (("-k 2000", 2000), ("-a", ALL_HITS)):
        pol = SearchPolicy(khits=khits, mhits=0, msample=False)
        launches, lines = parity_unpaired(f"host path, {label}", full, pol,
                                          names, seqs, quals, results=False)
        n_lines = len(lines)
        if launches["fm_walk"] == 0 or n_lines < n + 100 * n_unit:
            raise RuntimeError(f"{label}: fm_walk launches "
                               f"{launches['fm_walk']}, {n_lines} SAM lines")
    launches, _ = parity_unpaired(
        "host path, an index without its mirror direction",
        build_index(fa, both_directions=False), SearchPolicy(), names, seqs,
        quals, results=False)
    if launches["fm_walk"] == 0:
        raise RuntimeError("the mirror-less host path never launched "
                           "fm_walk")


def phase_parity_paired(pidx, chroms, n=512, force_big=None, shards=None):
    import torch
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.io.sam import sam_record
    from bowtie2_server_tpu_torch.ops import kernels
    names, s1, s2, quals, _ = make_pairs(23, chroms, n)
    sams = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launches()
        pal = PairedAligner(pidx, force_big=force_big,
                            **placed(dev, shards))
        pairs = pal.align_batch(make_batch(names, s1, quals),
                                make_batch(names, s2, quals))
        sams[dev] = [sam_record(r, pidx.ref_names)
                     for pr in pairs for r in pr]
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    what = "".join([", force_big" if force_big else "",
                    f", mesh of {shards} logical shards" if shards else ""])
    diff = sum(a != b for a, b in zip(sams["cuda"], sams["cpu"]))
    if diff or len(sams["cuda"]) != 2 * n:
        raise RuntimeError(f"{diff} paired SAM lines differ between CUDA "
                           f"and CPU{what}")
    log(f"CUDA vs CPU{what}: {n} pairs, SAM lines identical; card launches "
        f"{launches}")
    return launches


def phase_parity_big(idx, contigs, pidx, chroms, small, n=2048,
                     n_pairs=512):
    """The big-index path forced on both genomes, CUDA against CPU: phase
    5's n reads (and the card's SAM against `small`, the small path's SAM
    lines of those reads on the card) and n_pairs pairs."""
    from bowtie2_server_tpu_torch.align.pipeline import SearchPolicy
    names, seqs, quals, _ = make_reads(13, contigs, n)
    launches, big = parity_unpaired("force_big", idx, SearchPolicy(), names,
                                    seqs, quals, force_big=True)
    if launches["fm_resolve"] == 0:
        raise RuntimeError("the force_big card run never launched "
                           "fm_resolve")
    diff = sum(a != b for a, b in zip(big, small))
    if diff or len(big) != len(small):
        raise RuntimeError(f"{diff} SAM lines differ between the big and "
                           f"the small path on the card")
    log(f"big against small path on the card: {len(big)} SAM lines "
        f"identical")
    launches = phase_parity_paired(pidx, chroms, n_pairs, force_big=True)
    if launches["fm_resolve"] == 0:
        raise RuntimeError("the force_big pair run never launched "
                           "fm_resolve")


def phase_parity_wide(idx, contigs, maxhalf, n=2048):
    """One batch at --dpad maxhalf (WIDE_MAXHALVES: bands K = 256 and 512)
    on both devices: a path of the wide-band kernel. Returns its launch
    counts (zeroed just before the card's batch, read just after)."""
    import torch
    from bowtie2_server_tpu_torch.align.pipeline import (SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.io.sam import sam_record
    from bowtie2_server_tpu_torch.ops import kernels
    names, seqs, quals, _ = make_reads(15, contigs, n)
    pol = SearchPolicy(maxhalf=maxhalf)
    sams = {}
    for dev in ("cuda", "cpu"):
        al = UnpairedAligner(idx, policy=pol, device=dev)
        if dev == "cuda":
            kernels.reset_launches()
        recs = al.align_batch(make_batch(names, seqs, quals))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        sams[dev] = [sam_record(recs[i], idx.ref_names) for i in range(n)]
    diff = sum(a != b for a, b in zip(sams["cuda"], sams["cpu"]))
    if diff:
        raise RuntimeError(f"{diff} SAM lines differ between CUDA and CPU "
                           f"at --dpad {maxhalf}")
    log(f"CUDA vs CPU at --dpad {maxhalf} (band {al.band}): {n} reads, "
        f"SAM lines identical; kernel launches {launches}")
    if launches["sw_banded_wide"] == 0:
        raise RuntimeError(f"the --dpad {maxhalf} path never launched "
                           f"sw_banded_wide")
    return launches


_CIGAR = re.compile(r"^(\*|(\d+[MIDNSHP=X])+)$")


def write_fastq(path: Path, names, seqs, quals):
    with open(path, "w") as f:
        for nm, s, q in zip(names, seqs, quals):
            f.write(f"@{nm}\n{s.decode()}\n+\n{q.decode()}\n")


def run_cli(args, n_refs: int, n_recs: int, read_len: int, device: str):
    """`python -m bowtie2_server_tpu_torch align <args>` into a SAM file,
    which must be well-formed: a header with n_refs @SQ lines and n_recs
    primary records (and any secondary ones) of read_len bases. Returns
    (records as field lists, the summary's "overall alignment rate" line,
    seconds)."""
    sam = WORK / "out.sam"
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "bowtie2_server_tpu_torch", "align", *args,
         "-S", str(sam), "--device", device], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"CLI failed ({r.returncode}):\n{r.stderr}")
    lines = sam.read_text().splitlines()
    head = [ln for ln in lines if ln.startswith("@")]
    recs = [ln.split("\t") for ln in lines if not ln.startswith("@")]
    if not head or not head[0].startswith("@HD") or \
            sum(h.startswith("@SQ") for h in head) != n_refs:
        raise RuntimeError("SAM header malformed")
    n_prim = sum(not int(f[1]) & 0x100 for f in recs)
    if n_prim != n_recs:
        raise RuntimeError(f"SAM has {n_prim} primary records, expected "
                           f"{n_recs}")
    for f in recs:
        if len(f) < 11 or not f[1].isdigit() or not f[3].isdigit() \
                or not _CIGAR.match(f[5]) or len(f[9]) != read_len \
                or not f[8].lstrip("-").isdigit():
            raise RuntimeError(f"malformed SAM record: {f[:11]}")
    summ = [ln for ln in r.stderr.splitlines()
            if "overall alignment rate" in ln]
    return recs, summ[0] if summ else "", time.time() - t0


def phase_cli(base: Path, contigs, n=10_000, device="cuda"):
    names, seqs, quals, _ = make_reads(14, contigs, n)
    fq = WORK / "reads.fq"
    write_fastq(fq, names, seqs, quals)
    recs, summ, sec = run_cli(["-x", str(base), "-U", str(fq)], len(contigs),
                              n, READ_LEN, device)
    n_al = sum(not int(f[1]) & 4 for f in recs)
    if n_al < 0.95 * n:
        raise RuntimeError(f"only {n_al}/{n} CLI records aligned")
    log(f"CLI: {n} reads -> well-formed SAM in {sec:.1f} s (process "
        f"included); {n_al} aligned; {summ}")


def phase_cli_opts(base: Path, contigs, n=10_000, device="cuda"):
    """The CLI with -N 1 -L 20 and with -k 5 on n reads."""
    names, seqs, quals, _ = make_reads(14, contigs, n)
    fq = WORK / "reads.fq"
    write_fastq(fq, names, seqs, quals)
    for opts in (["-N", "1", "-L", "20"], ["-k", "5"]):
        recs, summ, sec = run_cli(["-x", str(base), "-U", str(fq), *opts],
                                  len(contigs), n, READ_LEN, device)
        prim = [f for f in recs if not int(f[1]) & 0x100]
        n_al = sum(not int(f[1]) & 4 for f in prim)
        if n_al < 0.95 * n:
            raise RuntimeError(f"{' '.join(opts)}: only {n_al}/{n} CLI "
                               f"records aligned")
        log(f"CLI {' '.join(opts)}: {n} reads -> well-formed SAM in "
            f"{sec:.1f} s (process included); {n_al} aligned, "
            f"{len(recs) - len(prim)} secondary records; {summ}")


def phase_cli_paired(pbase: Path, chroms, n=5000, device="cuda"):
    names, s1, s2, quals, _ = make_pairs(24, chroms, n)
    fqs = [WORK / "p1.fq", WORK / "p2.fq"]
    for fq, seqs in zip(fqs, (s1, s2)):
        write_fastq(fq, names, seqs, quals)
    recs, summ, sec = run_cli(
        ["-x", str(pbase), "-1", str(fqs[0]), "-2", str(fqs[1])],
        len(chroms), 2 * n, PAIR_LEN, device)
    n_al = n_proper = 0
    for k, f in enumerate(recs):
        flag = int(f[1])
        mate = 0x40 if k % 2 == 0 else 0x80
        if not flag & 1 or not flag & mate or f[0] != names[k // 2]:
            raise RuntimeError(f"SAM record {k} out of pair order: {f[:2]}")
        n_al += not flag & 4
        n_proper += bool(flag & 2)
    if n_al < 0.95 * 2 * n:
        raise RuntimeError(f"only {n_al}/{2 * n} paired CLI records aligned")
    log(f"paired CLI: {n} pairs -> well-formed SAM of {2 * n} records in "
        f"{sec:.1f} s (process included); {n_al} aligned, {n_proper} in "
        f"proper pairs; {summ}")


def opts_main(argv, device: str):
    """The port's CLI (`__main__.main`) in process on `device`: (kernel
    launches of the run, zeroed just before and read just after, and
    seconds)."""
    import torch
    from bowtie2_server_tpu_torch.__main__ import main as cli_main
    from bowtie2_server_tpu_torch.ops import kernels
    kernels.reset_launches()
    t0 = time.time()
    cli_main([*argv, "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(kernels.LAUNCHES), time.time() - t0


def sam_records(path: Path):
    """SAM record lines (the header aside) of a file."""
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("@")]


def sam_origin_fraction(lines, origin, local: bool) -> float:
    """Fraction of reads (one primary record each, in input order) at their
    planted origin and strand; local: the start inside the read span."""
    cid, start, fw = origin
    recs = [ln.split("\t", 4) for ln in lines]
    if len(recs) != len(cid):
        raise RuntimeError(f"{len(recs)} SAM records for {len(cid)} reads")
    ok = 0
    for f, c, s, w in zip(recs, cid, start, fw):
        flag, pos = int(f[1]), int(f[3]) - 1
        hit = (not flag & 4 and f[2] == f"ctg{c}"
               and ((flag & 16) == 0) == bool(w))
        ok += hit and (s <= pos < s + READ_LEN if local else pos == s)
    return ok / len(recs)


def opts_parity(label, argv, outputs=("out.sam",)):
    """One command line on the card and on the CPU, each run in a directory
    of its own under WORK/opts (relative output names land there): every
    output equal (SAM with @PG aside; BAM after decoding its BGZF blocks).
    Returns (the card run's launches, {device: its directory})."""
    import os
    from bowtie2_server_tpu_torch.io.bam import _bgzf_blocks
    got, dirs = {}, {}
    here = os.getcwd()
    for dev in ("cuda", "cpu"):
        d = WORK / "opts" / re.sub(r"\W+", "_", label).strip("_") / dev
        d.mkdir(parents=True, exist_ok=True)
        dirs[dev] = d
        os.chdir(d)
        try:
            launches, sec = opts_main(argv, dev)
        finally:
            os.chdir(here)
        if dev == "cuda":
            card = launches, sec
        got[dev] = {}
        for o in outputs:
            if o.endswith(".bam"):
                with open(d / o, "rb") as fh:
                    got[dev][o] = b"".join(_bgzf_blocks(fh))
            else:
                got[dev][o] = [ln for ln in (d / o).read_text().splitlines()
                               if not ln.startswith("@PG")]
    for o in outputs:
        a, b = got["cuda"][o], got["cpu"][o]
        if a != b:
            n = (f"{sum(x != y for x, y in zip(a, b))} of {len(a)} lines"
                 if isinstance(a, list) else "the decoded bytes")
            raise RuntimeError(f"OPTS {label}: {o} differs between CUDA and "
                               f"CPU ({n})")
        if not a:
            raise RuntimeError(f"OPTS {label}: {o} is empty")
    unit = "decoded bytes" if outputs[0].endswith(".bam") else "lines"
    log(f"OPTS {label}: CUDA equals CPU, zero differing lines in "
        f"{', '.join(outputs)} ({len(got['cuda'][outputs[0]])} {unit} in "
        f"{outputs[0]}); card run {card[1]:.1f} s, launches {card[0]}")
    return card[0], dirs


def write_opts_inputs(d: Path, contigs):
    """OPTS_PARITY reads of phase 4's workload (every 50th replaced by
    random bases, so --un gets reads) as FASTQ, FASTA, tab6, and BAM
    written by the port's BamWriter (unaligned records with tags, every 4th
    on the reverse strand)."""
    from bowtie2_server_tpu_torch.io.bam import BamWriter
    names, seqs, quals, _ = make_reads(62, contigs, OPTS_PARITY)
    rng = np.random.default_rng(64)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i in range(0, len(seqs), 50):
        seqs[i] = bases[rng.integers(0, 4, READ_LEN)].tobytes()
    d.mkdir(parents=True, exist_ok=True)
    write_fastq(d / "reads.fq", names, seqs, quals)
    (d / "reads.fa").write_text("".join(
        f">{n}\n{s.decode()}\n" for n, s in zip(names, seqs)))
    (d / "reads.tab").write_text("".join(
        f"{n}\t{s.decode()}\t{q.decode()}\n"
        for n, s, q in zip(names, seqs, quals)))
    comp = str.maketrans("ACGTN", "TGCAN")
    with open(d / "reads.bam", "wb") as fh:
        w = BamWriter(fh, "@HD\tVN:1.0\tSO:unsorted\n", [], [])
        for i, (n, s, q) in enumerate(zip(names, seqs, quals)):
            s, q, flag = s.decode(), q.decode(), 4
            if i % 4 == 1:
                s, q, flag = s[::-1].translate(comp), q[::-1], 20
            w.write_sam_line(f"{n}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t{s}\t{q}"
                             f"\tRG:Z:lane{i % 3}\tXI:i:{i}")
        w.close()
    return {k: str(d / k) for k in ("reads.fq", "reads.fa", "reads.tab",
                                    "reads.bam")}


def tsv_counters(path: Path):
    """The --met TSV's columns other than OPTS_NOT_COUNTERS, row by row."""
    from bowtie2_server_tpu_torch.io.metrics import PERF_COLUMNS
    rows = [ln.split("\t") for ln in path.read_text().splitlines()]
    if rows[0] != list(PERF_COLUMNS) or len(rows) < 2:
        raise RuntimeError(f"{path}: not a --met TSV with a data row")
    keep = [k for k, c in enumerate(PERF_COLUMNS)
            if c not in OPTS_NOT_COUNTERS]
    return [[r[k] for k in keep] for r in rows[1:]]


def phase_opts(base: Path, contigs, pbase: Path, chroms):
    """Phase OPTS: the rest of the align command line and the dp subcommand
    on the card, through the port's CLI in process. Returns the path's
    numbers for the paths line."""
    t_phase = time.time()
    d = WORK / "opts"
    res = {}
    # full width: phase 4's genome, 32768 reads at the main path's batch
    d.mkdir(parents=True, exist_ok=True)
    names, seqs, quals, origin = make_reads(61, contigs, BATCH)
    write_fastq(d / "full.fq", names, seqs, quals)
    for preset, n, local in (("--very-sensitive", BATCH, False),
                             ("--very-fast-local", OPTS_LOCAL_READS, True)):
        fq = d / "full.fq"
        if n < BATCH:
            fq = d / "full_local.fq"
            write_fastq(fq, names[:n], seqs[:n], quals[:n])
        # warm-up: the preset's k-mer table is built and cached on disk
        # under the index base (its seed length differs from phase 4's)
        write_fastq(d / "warm.fq", names[:1024], seqs[:1024], quals[:1024])
        opts_main(["align", "-x", str(base), "-U", str(d / "warm.fq"), "-S",
                   str(d / "warm.sam"), preset], "cuda")
        launches, sec = opts_main(
            ["align", "-x", str(base), "-U", str(fq), "-S",
             str(d / "full.sam"), "--batch", str(BATCH), preset], "cuda")
        frac = sam_origin_fraction(sam_records(d / "full.sam"),
                                   tuple(o[:n] for o in origin), local)
        log(f"OPTS align {preset}: {n} reads of {READ_LEN} bp at --batch "
            f"{BATCH}: {n / sec:.1f} reads/s (index load, FASTQ parse and "
            f"SAM write included); at planted origin and strand {frac:.4f}; "
            f"launches sw_banded {launches['sw_banded']}, sw_banded_general "
            f"{launches['sw_banded_general']}, sw {launches['sw']}; "
            f"{card_line()}")
        lim = ORIGIN_MIN_LOCAL if local else ORIGIN_MIN_E2E
        if frac < lim:
            raise RuntimeError(f"OPTS {preset}: origin fraction {frac:.4f} "
                               f"< {lim}")
        if launches["sw_banded"] == 0:
            raise RuntimeError(f"OPTS {preset}: sw_banded never launched")
        res[preset.lstrip("-")] = dict(reads=n, reads_per_s=n / sec,
                                       origin=frac, launches=launches)
    f = write_opts_inputs(d / "in", contigs)
    x = ["align", "-x", str(base)]
    # the wide-band kernel from the command line
    for dpad in WIDE_MAXHALVES:
        launches, _ = opts_parity(f"--dpad {dpad}", [
            *x, "-U", f["reads.fq"], "--dpad", str(dpad), "-S", "out.sam"])
        if launches["sw_banded_wide"] == 0:
            raise RuntimeError(f"OPTS: align --dpad {dpad} never launched "
                               f"sw_banded_wide")
        res[f"dpad{dpad}_wide_launches"] = launches["sw_banded_wide"]
    # input formats and outputs; the last also writes the --met TSV, the DP
    # problems and -t's stage times
    opts_parity("-b", [*x, "-b", "-U", f["reads.bam"], "-S", "out.sam"])
    opts_parity("-b --preserve-tags --output-bam", [
        *x, "-b", "-U", f["reads.bam"], "--preserve-tags", "--output-bam",
        "-S", "out.bam"], outputs=("out.bam",))
    opts_parity("-f --trim-to 3:80 --un --al", [
        *x, "-f", "-U", f["reads.fa"], "--trim-to", "3:80", "--un", "un.fq",
        "--al", "al.fq", "-S", "out.sam"],
        outputs=("out.sam", "un.fq", "al.fq"))
    _, met_dirs = opts_parity(
        "--tab6 --xeq --rg-id x --rg SM:y --met-file --dp-log -t "
        "--batch 512", [
            *x, "--tab6", f["reads.tab"], "--xeq", "--rg-id", "x", "--rg",
            "SM:y", "--met-file", "met.tsv", "--met-read", "--dp-log",
            "dp.txt", "-t", "--batch", "512", "-S", "out.sam"],
        outputs=("out.sam", "dp.txt"))
    cuda_met = tsv_counters(met_dirs["cuda"] / "met.tsv")
    if cuda_met != tsv_counters(met_dirs["cpu"] / "met.tsv"):
        raise RuntimeError("OPTS: the --met TSV's counter columns differ "
                           "between CUDA and CPU")
    log(f"OPTS --met TSV: {len(cuda_met)} rows, counter columns equal CUDA "
        f"and CPU (columns excluded: {', '.join(sorted(OPTS_NOT_COUNTERS))}"
        f": time and memory)")
    # paired options on phase PE's genome
    pn, s1, s2, pq, _ = make_pairs(63, chroms, OPTS_PAIRS)
    rng = np.random.default_rng(65)     # every 50th mate 2 random: the pair
    bases = np.frombuffer(b"ACGT", np.uint8)    # goes to --un-conc
    for i in range(0, len(s2), 50):
        s2[i] = bases[rng.integers(0, 4, PAIR_LEN)].tobytes()
    write_fastq(d / "in" / "m1.fq", pn, s1, pq)
    write_fastq(d / "in" / "m2.fq", pn, s2, pq)
    opts_parity("paired --dovetail --no-contain --no-overlap --un-conc "
                "--al-conc", [
                    "align", "-x", str(pbase), "-1", str(d / "in" / "m1.fq"),
                    "-2", str(d / "in" / "m2.fq"), "--dovetail",
                    "--no-contain", "--no-overlap", "--un-conc", "unc%.fq",
                    "--al-conc", "alc%.fq", "-S", "out.sam"],
                outputs=("out.sam", "unc1.fq", "unc2.fq", "alc1.fq",
                         "alc2.fq"))
    # dp on the problems the card run logged
    rows = (met_dirs["cuda"] / "dp.txt").read_text().splitlines()
    rows = rows[:OPTS_DP_PROBLEMS]
    (d / "dp.txt").write_text("".join(r + "\n" for r in rows))
    out = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launches, sec = opts_main(["dp", str(d / "dp.txt")], dev)
        out[dev] = buf.getvalue().splitlines()
        if dev == "cuda":
            dp_launches, dp_sec = launches, sec
    if out["cuda"] != out["cpu"] or len(out["cuda"]) != len(rows):
        n = sum(a != b for a, b in zip(out["cuda"], out["cpu"]))
        raise RuntimeError(f"OPTS dp: {n} of {len(rows)} lines differ "
                           f"between CUDA and CPU")
    if dp_launches["sw"] == 0:
        raise RuntimeError("OPTS dp --device cuda never launched sw")
    log(f"OPTS dp: {len(rows)} logged problems, CUDA equals CPU, zero "
        f"differing lines; card run {dp_sec:.1f} s, launches {dp_launches}")
    res["dp_sw_launches"] = dp_launches["sw"]
    res["seconds"] = time.time() - t_phase
    log(f"phase OPTS in {res['seconds']:.1f} s on {card_line()}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", action="store_true", help=(
        "only phases 1, 2, 4 (end-to-end), SR, BIG and PE; the last line "
        "is their "
        "JSON. To compare two checkouts in turns on one card, run a copy "
        "of this script placed in the root of each"))
    ap.add_argument("--opts", action="store_true", help=(
        "only phases 1, 2 and OPTS (the genomes built first)"))
    ap.add_argument("--mesh", action="store_true", help=(
        "only phases 1, 2 and MESH (the genomes built first)"))
    ap.add_argument("--tb", action="store_true", help=(
        "only phases 1, 2 and TB"))
    cli = ap.parse_args(argv)
    paths_only = cli.paths
    card = phase_env()
    import torch
    from bowtie2_server_tpu_torch.index.build import build_index
    from bowtie2_server_tpu_torch.index.fm import FmIndex
    t_all = time.time()
    phase_build()
    if cli.tb:
        log(json.dumps({"kernels": {"sw_banded_tb": phase_tb()}}))
        return
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    fa, contigs = make_genome(42, CHROM_LEN, N_CONTIGS, CONTIG_LEN)
    base = WORK / "genome"
    build_index(fa).save(base)
    idx = FmIndex.load(base)      # sets the k-mer table's disk cache base
    log(f"genome {idx.n} bp in {len(contigs)} sequences, index built in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    pfa, chroms = make_genome(43, P_CHROM_LEN, P_CHROMS - 1, P_CHROM_LEN)
    pbase = WORK / "pgenome"
    build_index(pfa).save(pbase)
    pidx = FmIndex.load(pbase)
    log(f"paired genome {pidx.n} bp in {len(chroms)} chromosomes, index "
        f"built in {time.time() - t0:.1f} s")
    if cli.opts:
        log(json.dumps({"paths": {"opts": phase_opts(base, contigs, pbase,
                                                     chroms)}}))
        return
    if cli.mesh:
        log(json.dumps({"paths": {"mesh": phase_mesh(base, idx, contigs,
                                                     pidx, chroms)}}))
        return
    if paths_only:
        _, main_res = phase_main(idx, contigs, local=False)
        _, sr_res, _ = phase_short(idx, contigs)
        _, big_res, _ = phase_big(idx, contigs)
        _, pe_res = phase_paired(pidx, chroms)
        log(card_line())
        log(json.dumps({"paths": {"unpaired": main_res, "short": sr_res,
                                  "big": big_res, "paired": pe_res},
                        "package": str(ROOT)}))
        return
    times = phase_kernels(contigs)
    times["sw_banded_tb"] = phase_tb(times["alu_probe"]["ceiling_ops_per_s"])
    dp_launches = phase_dp_bench()
    launches, main_res = phase_main(idx, contigs)
    sr_launches, sr_res, sr_cap = phase_short(idx, contigs)
    n1_res, n1_cap = phase_n1(idx, contigs)
    ceiling = times["alu_probe"]["ceiling_ops_per_s"]
    times.update(phase_fm_kernels(idx, sr_cap, n1_cap, ceiling))
    del sr_cap, n1_cap              # their tensors: the card's memory back
    big_launches, big_res, big_cap = phase_big(idx, contigs)
    times["fm_resolve"], times["fm_walk"]["uint32"] = phase_big_kernels(
        idx, big_cap, ceiling, times["fm_walk"]["step_latency_ms"])
    hbm = phase_hbm(ceiling)
    times["fm_walk"]["hbm"] = hbm["fm_walk"]
    times["fm_resolve"]["hbm"] = hbm["fm_resolve"]
    times["fm_walk"]["max_abs_err"] = max(
        times["fm_walk"]["max_abs_err"],
        times["fm_walk"]["uint32"]["max_abs_err"])
    del big_cap
    pe_launches, pe_res = phase_paired(pidx, chroms)
    srv_res = phase_server(base, contigs, pbase, chroms)
    mesh_res = phase_mesh(base, idx, contigs, pidx, chroms)
    small_sam = phase_parity(idx, contigs)
    phase_parity_short(idx, contigs)
    phase_parity_host()
    phase_parity_paired(pidx, chroms)
    phase_parity_big(idx, contigs, pidx, chroms, small_sam)
    wide_launches = [phase_parity_wide(idx, contigs, m)
                     for m in WIDE_MAXHALVES]
    phase_cli(base, contigs)
    phase_cli_opts(base, contigs)
    phase_cli_paired(pbase, chroms)
    opts_res = phase_opts(base, contigs, pbase, chroms)
    # each kernel's launches on its path: the unpaired main path for the
    # banded and rectangle kernels (the paired path is checked above), the
    # short-read path for the FM kernels, the --dpad 32 and --dpad 64
    # batches for the wide-band kernel, the DP microbench for the probe,
    # the big-index path for fm_resolve, the --local batch for the
    # traceback kernel
    path_launches = dict(sw_banded=launches["sw_banded"],
                         sw_banded_general=launches["sw_banded_general"],
                         sw=launches["sw"],
                         sw_banded_wide=sum(w["sw_banded_wide"]
                                            for w in wide_launches),
                         sw_banded_tb=launches["local_sw_banded_tb"],
                         alu_probe=dp_launches["alu_probe"],
                         fm_walk=sr_launches["fm_walk"],
                         fm_lf_step=sr_launches["fm_lf_step"],
                         fm_resolve=big_launches["fm_resolve"])
    log(f"launches on the paired path: {pe_launches}")
    log(json.dumps({"paths": {"unpaired": main_res, "paired": pe_res,
                              "short": sr_res, "n1": n1_res,
                              "big": big_res, "server": srv_res,
                              "mesh": mesh_res, "opts": opts_res}}))
    # no PyTorch call computes any of these functions (a DP, the probe's
    # chain, an FM walk, a walk-left): library_ms is null
    kern = [dict(name=name, route="cuda",
                 source=f"bowtie2_server_tpu_torch/ops/csrc/{src}",
                 replaces=tpu, launches=path_launches[name], library_ms=None,
                 **times[name])
            for name, (src, tpu) in KERNEL_SOURCES.items()]
    log(f"all phases passed in {time.time() - t_all:.1f} s")
    log(card_line() or card)
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # report the failed phase; no result line
        import traceback
        traceback.print_exc()
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
