#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100, sm_90a).

Run from the root of a checkout:  python3 chip_smoke.py

It imports nothing of JAX. Phases, in order; any failure exits non-zero and
prints no result line:
  1. environment: torch and CUDA versions, the card's name and power limit;
     fails without a CUDA device;
  2. build: nvcc builds the port's kernels from ops/csrc/;
  3. kernels: each CUDA kernel against its plain torch version on the same
     CUDA tensors, at the main path's shapes (exact equality, tolerance 0:
     all values are int32), with the median time of each;
  4. the main path at full size: a 4 Mbp synthetic genome (a 3.6 Mbp
     chromosome plus 400 contigs of 1 kbp, the shape of a draft assembly,
     so the run-boundary rectangle DP runs in every batch) with the full
     k-mer seed table on the device; UnpairedAligner(device='cuda') over
     8 batches of 32768 reads of 100 bp (0-3 substitutions, half reverse
     complemented) at dispatch depth 4, as bench.py drives the reference
     package; then one --local batch of 8192 reads. Launch counters are zeroed just before
     and read just after; placement at the planted origin is checked;
  5. CUDA against CPU: one batch of 2048 reads through the port on both
     devices; the decoded batch results and SAM lines must be identical;
  6. the entry point: `python -m bowtie2_server_tpu_torch align` on 10k reads
     must write a well-formed SAM.
The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}.
"""
import json
import re
import statistics
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
DEPTH = 4           # batches in flight (bench.py's dispatch depth)
# --local sends every winner through the host traceback (numpy, a few ms
# a read), so its one batch is cut to a quarter of BATCH
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
KERNEL_TPU_SOURCES = {
    "sw_banded": "bowtie2_server_tpu/ops/sw_banded.py:240",
    "sw": "bowtie2_server_tpu/ops/sw.py:282",
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


def make_reads(seed: int, contigs, n: int):
    """bench.py-shaped reads drawn uniformly over the genome: (names, seqs,
    quals, origin) with origin = (contig id, 0-based start, forward?)."""
    rng = np.random.default_rng(seed)
    starts_per = np.array([len(c) - READ_LEN + 1 for c in contigs])
    cum = np.cumsum(starts_per)
    u = rng.integers(0, cum[-1], n)
    cid = np.searchsorted(cum, u, side="right")
    start = u - (cum[cid] - starts_per[cid])
    flat = np.concatenate(contigs)
    off = np.concatenate([[0], np.cumsum([len(c) for c in contigs])[:-1]])
    reads = flat[(off[cid] + start)[:, None] + np.arange(READ_LEN)]
    nmut = rng.integers(0, 4, n)
    for k in range(3):                  # 0-3 substitutions per read
        m = nmut > k
        pos = rng.integers(0, READ_LEN, n)
        reads[m, pos[m]] = rng.integers(0, 4, n).astype(np.uint8)[m]
    with_n = rng.random(n) < 0.01
    reads[with_n, rng.integers(0, READ_LEN, n)[with_n]] = 4
    rc = rng.random(n) < 0.5
    reads[rc] = np.where(reads[rc] < 4, 3 - reads[rc], 4)[:, ::-1]
    arr = np.frombuffer(b"ACGTN", np.uint8)[reads]
    names = [f"b{i}" for i in range(n)]
    seqs = [row.tobytes() for row in arr]
    quals = [b"I" * READ_LEN] * n
    return names, seqs, quals, (cid, start, ~rc)


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


def origin_fraction(recs, origin, local: bool) -> float:
    aligned, rid, pos, fw = placements(recs)
    cid, start, ofw = origin
    ok = aligned & (rid == cid) & (fw == ofw)
    if local:    # soft clipping moves the start inside the read span
        ok &= (pos >= start) & (pos < start + READ_LEN)
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


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() on the card (CUDA events, after a
    warm-up run and a synchronize)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def banded_problems(contigs, seed: int, P: int, K: int, lq: int):
    """[rows, P] int32 inputs at the fused stage's shapes: half the bands
    cut from the genome around planted reads (as the band gather does),
    half random; ragged lengths; mismatch penalties of Phred qualities."""
    rng = np.random.default_rng(seed)
    chrom = contigs[0]
    s = rng.integers(K, len(chrom) - lq - 2 * K, P)
    band = chrom[(s - K // 2)[None, :] + np.arange(lq + K)[:, None]]
    band = band.astype(np.int32)
    rd = band[K // 2 : K // 2 + lq].copy()
    for _ in range(3):
        rd[rng.integers(0, lq, P), np.arange(P)] = rng.integers(0, 4, P)
    rnd = np.arange(P) % 2 == 1
    band[:, rnd] = rng.integers(0, 4, (lq + K, int(rnd.sum())))
    rd[rng.integers(0, lq, P // 16), rng.integers(0, P, P // 16)] = 5
    mm = rng.integers(2, 7, (lq, P)).astype(np.int32)
    lens = np.where(np.arange(P) % 5 == 0, rng.integers(60, lq + 1, P), lq)
    return [np.ascontiguousarray(a, np.int32) for a in (rd, mm, lens, band)]


def phase_kernels(contigs):
    """Each kernel against its plain torch version on the same CUDA
    tensors. Returns per-kernel {max_abs_err, ms, plain_ms}."""
    import torch
    from bowtie2_server_tpu_torch.ops import sw as tsw
    from bowtie2_server_tpu_torch.ops import sw_banded as tsb
    dev = torch.device("cuda")
    out = {}
    K, lq, P = 64, 128, 33792           # the fused stage's main-path shape
    args = [torch.from_numpy(a).to(dev)
            for a in banded_problems(contigs, 5, P, K, lq)]
    errs, times = [], {}
    for local in (False, True):
        cfg = tsw.SwConfig(ma=2, local=True) if local else tsw.SwConfig()
        got = tsb.banded_dp(cfg, K, *args)
        want = tsb.banded_tile_torch(cfg, K, *args)
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        ms = cuda_ms(lambda: tsb.banded_dp(cfg, K, *args))
        pms = cuda_ms(lambda: tsb.banded_tile_torch(cfg, K, *args), reps=3)
        mode = "local" if local else "e2e"
        log(f"sw_banded {mode}: Lq={lq} K={K} P={P} max_abs_err={err} "
            f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
        errs.append(err)
        times[mode] = (ms, pms)
    out["sw_banded"] = dict(max_abs_err=max(errs), ms=times["e2e"][0],
                            plain_ms=times["e2e"][1])

    lq_pad, lc, P = 128, 256, 4096
    rng = np.random.default_rng(6)
    ref = rng.integers(0, 4, (lc, P)).astype(np.int32)
    s = rng.integers(0, lc - lq_pad, P)
    rd = ref[s[None, :] + np.arange(lq_pad)[:, None], np.arange(P)]
    for _ in range(3):
        rd[rng.integers(0, lq_pad, P), np.arange(P)] = rng.integers(0, 4, P)
    rd[:, ::3] = rng.integers(0, 4, (lq_pad, len(range(0, P, 3))))
    lens = rng.integers(90, lq_pad + 1, P).astype(np.int32)
    rd[np.arange(lq_pad)[:, None] >= lens[None, :]] = 5
    reflens = rng.integers(lq_pad, lc + 1, P).astype(np.int32)
    mm = rng.integers(2, 7, (lq_pad, P)).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in (rd, mm, lens, ref, reflens)]
    errs, times = [], {}
    for local in (False, True):
        cfg = tsw.SwConfig(ma=2, local=True) if local else tsw.SwConfig()
        got = tsw.sw_tile(cfg, *args)
        want = tsw.sw_tile_torch(cfg, *args)
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        ms = cuda_ms(lambda: tsw.sw_tile(cfg, *args))
        pms = cuda_ms(lambda: tsw.sw_tile_torch(cfg, *args), reps=3)
        mode = "local" if local else "e2e"
        log(f"sw (rect) {mode}: Lq_pad={lq_pad} Lc={lc} P={P} "
            f"max_abs_err={err} kernel {ms:.3f} ms, plain {pms:.3f} ms")
        errs.append(err)
        times[mode] = (ms, pms)
    out["sw"] = dict(max_abs_err=max(errs), ms=times["e2e"][0],
                     plain_ms=times["e2e"][1])
    for name, r in out.items():
        if r["max_abs_err"] != 0:
            raise RuntimeError(f"{name}: kernel disagrees with its plain "
                               f"version (max_abs_err {r['max_abs_err']})")
    return out


def run_main_path(idx, contigs, device, batch, n_batches, seed=11):
    """bench.py's loop on the port: one warm-up batch, then n_batches at
    dispatch depth DEPTH. Returns (reads/s, aligned fraction, origin
    fraction, warm-up seconds)."""
    import torch
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    names, seqs, quals, origin = make_reads(seed, contigs,
                                            batch * (n_batches + 1))
    batches = [make_batch(names[i : i + batch], seqs[i : i + batch],
                          quals[i : i + batch])
               for i in range(0, len(names), batch)]
    al = UnpairedAligner(idx, device=device)
    t0 = time.time()
    outs = [al.align_batch(batches[0])]
    warm = time.time() - t0
    t0 = time.time()
    inflight = deque()
    for b in batches[1:]:
        inflight.append(al.align_async(b))
        if len(inflight) >= DEPTH:
            outs.append(al.align_wait(inflight.popleft()))
    while inflight:
        outs.append(al.align_wait(inflight.popleft()))
    if al.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    n = batch * n_batches
    aligned = sum(r.n_aligned() for r in outs[1:]) / n
    frac = np.mean([origin_fraction(r, tuple(o[i * batch : (i + 1) * batch]
                                             for o in origin), False)
                    for i, r in enumerate(outs)])
    return n / dt, aligned, float(frac), warm


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


def phase_main(idx, contigs):
    import torch
    from bowtie2_server_tpu_torch.ops import kernels
    kernels.reset_launches()
    rps, aligned, frac, warm = run_main_path(idx, contigs, "cuda", BATCH,
                                             N_BATCHES)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"main path (e2e): {rps:.1f} reads/s over {N_BATCHES} batches of "
        f"{BATCH} at depth {DEPTH} (warm-up batch {warm:.2f} s); aligned "
        f"{aligned:.4f}; at planted origin and strand {frac:.4f}; "
        f"kernel launches {launches}")
    if frac < ORIGIN_MIN_E2E:
        raise RuntimeError(f"origin fraction {frac:.4f} < {ORIGIN_MIN_E2E}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"the main path never launched {name}")
    l_rps, l_aligned, l_frac = run_local_batch(idx, contigs, "cuda",
                                               LOCAL_BATCH)
    log(f"main path (--local, one batch of {LOCAL_BATCH}): {l_rps:.1f} "
        f"reads/s; "
        f"aligned {l_aligned:.4f}; origin inside the read span and strand "
        f"{l_frac:.4f}")
    if l_frac < ORIGIN_MIN_LOCAL:
        raise RuntimeError(f"local origin fraction {l_frac:.4f} < "
                           f"{ORIGIN_MIN_LOCAL}")
    return launches


def phase_parity(idx, contigs, n=2048):
    from bowtie2_server_tpu_torch.align.candgen import BatchResult
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.io.sam import sam_record
    names, seqs, quals, _ = make_reads(13, contigs, n)
    sams, results = {}, {}
    for dev in ("cuda", "cpu"):
        al = UnpairedAligner(idx, device=dev)
        batch = make_batch(names, seqs, quals)
        results[dev] = al.collect(batch).res
        recs = al.align_batch(batch)
        sams[dev] = [sam_record(recs[i], idx.ref_names) for i in range(n)]
    for name in BatchResult.__slots__:
        a, b = getattr(results["cuda"], name), getattr(results["cpu"], name)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b)
        if not same:
            raise RuntimeError(f"CUDA and CPU differ in BatchResult.{name}")
    diff = sum(a != b for a, b in zip(sams["cuda"], sams["cpu"]))
    if diff:
        raise RuntimeError(f"{diff} SAM lines differ between CUDA and CPU")
    log(f"CUDA vs CPU: {n} reads, BatchResult fields and SAM lines "
        f"identical")


_CIGAR = re.compile(r"^(\*|(\d+[MIDNSHP=X])+)$")


def phase_cli(base: Path, contigs, n=10_000, device="cuda"):
    names, seqs, quals, _ = make_reads(14, contigs, n)
    fq = WORK / "reads.fq"
    sam = WORK / "out.sam"
    with open(fq, "w") as f:
        for nm, s, q in zip(names, seqs, quals):
            f.write(f"@{nm}\n{s.decode()}\n+\n{q.decode()}\n")
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "bowtie2_server_tpu_torch", "align", "-x",
         str(base), "-U", str(fq), "-S", str(sam), "--device", device],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"CLI failed ({r.returncode}):\n{r.stderr}")
    lines = sam.read_text().splitlines()
    head = [ln for ln in lines if ln.startswith("@")]
    recs = [ln.split("\t") for ln in lines if not ln.startswith("@")]
    if not head or not head[0].startswith("@HD") or \
            sum(h.startswith("@SQ") for h in head) != len(contigs):
        raise RuntimeError("SAM header malformed")
    if len(recs) != n:
        raise RuntimeError(f"SAM has {len(recs)} records, expected {n}")
    n_al = 0
    for f in recs:
        if len(f) < 11 or not f[1].isdigit() or not f[3].isdigit() \
                or not _CIGAR.match(f[5]) or len(f[9]) != READ_LEN:
            raise RuntimeError(f"malformed SAM record: {f[:11]}")
        n_al += not int(f[1]) & 4
    if n_al < 0.95 * n:
        raise RuntimeError(f"only {n_al}/{n} CLI records aligned")
    summ = [ln for ln in r.stderr.splitlines()
            if "overall alignment rate" in ln]
    log(f"CLI: {n} reads -> well-formed SAM in {time.time() - t0:.1f} s "
        f"(process included); {n_al} aligned; {summ[0] if summ else ''}")


def main():
    card = phase_env()
    import torch
    from bowtie2_server_tpu_torch.index.build import build_index
    from bowtie2_server_tpu_torch.index.fm import FmIndex
    t_all = time.time()
    phase_build()
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    fa, contigs = make_genome(42, CHROM_LEN, N_CONTIGS, CONTIG_LEN)
    base = WORK / "genome"
    build_index(fa).save(base)
    idx = FmIndex.load(base)      # sets the k-mer table's disk cache base
    log(f"genome {idx.n} bp in {len(contigs)} sequences, index built in "
        f"{time.time() - t0:.1f} s")
    times = phase_kernels(contigs)
    launches = phase_main(idx, contigs)
    phase_parity(idx, contigs)
    phase_cli(base, contigs)
    kern = [dict(name=name, route="cuda",
                 source=f"bowtie2_server_tpu_torch/ops/csrc/{name}.cu",
                 replaces=KERNEL_TPU_SOURCES[name],
                 launches=launches[name], **times[name])
            for name in ("sw_banded", "sw")]
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
