"""The big-index path past 2^31 on the card: build a synthetic joined text
of 2,148,532,224 bp (2^31 + 2^20, the length of the JAX package's
scripts/bench_big_index.py text, past the int32 offset ceiling that the
reference serves with its `-l` / BOWTIE_64BIT_INDEX build line) with the
native 64-bit SA-IS (native/sais.cpp `bt2tpu_sais64`), load it on one card
through the big layout (uint32 rows, sampled SA; ops/fm.py), and align
reads of 100 bp, half of them planted past offset 2^31 - 10^4, so that
rows and offsets at and above 2^31 go through the uint32 instantiations of
the FM walks, fm_resolve and the biased diagonals.

    python -m bowtie2_server_tpu_torch.scripts.bench_big_index \\
        [--n-reads 65536] [--batch 16384] [--no-cache] [--device cuda]

It logs the machine (free -g, nproc, the disk under tmp/) and the build
time of each direction, and prints one JSON line: reads/s over the batches
after the first, aligned and placed-at-origin fractions (all reads, and
those planted past 2^31), the kernels' launches, one more batch under
torch.profiler (the device busy share; the FM kernels' and the banded
kernel's device time with the index's tables in HBM), the index's bytes
on the card, the card's name and power limit. The built directions are cached
under tmp/bigidx_port/ (about 25 GB; --no-cache skips it), so a rerun on
the same disk skips the build. --n (a shorter text) and --device cpu are
for trying the script out at small size.
"""
from __future__ import annotations

import argparse
import json
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N = (1 << 31) + (1 << 20)
READ_LEN = 100
ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "tmp" / "bigidx_port"
DIR_FIELDS = ("bwt", "occ", "cnt", "sa", "ftab_top", "ftab_bot")


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True)
    return r.stdout.strip() if r.returncode == 0 else f"({cmd[0]} failed)"


def machine() -> dict:
    CACHE.parent.mkdir(parents=True, exist_ok=True)
    out = dict(free_g=_run(["free", "-g"]), nproc=_run(["nproc"]),
               disk_free_gb=shutil.disk_usage(CACHE.parent).free / 1e9)
    log(f"free -g:\n{out['free_g']}\nnproc: {out['nproc']}; disk free under "
        f"tmp/: {out['disk_free_gb']:.1f} GB")
    return out


def text_of(n: int, seed: int = 3) -> np.ndarray:
    """n random bases (codes 0..3), made in chunks."""
    rng = np.random.default_rng(seed)
    g = np.empty(n, np.uint8)
    ch = 1 << 28
    for lo in range(0, n, ch):
        g[lo : lo + ch] = rng.integers(0, 4, min(ch, n - lo), dtype=np.uint8)
    return g


def build_or_load(n: int, cache: bool):
    """The index of text_of(n): (FmIndex, {direction: {sa_s, direction_s}}
    or None when loaded from the cache)."""
    from ..index.build import _build_direction, suffix_array
    from ..index.fm import FmDirection, FmIndex
    base = CACHE / str(n)
    done = base / "DONE"
    times = None
    if cache and done.exists():
        log(f"loading the cached index from {base}")
        g = np.load(base / "joined.npy", mmap_mode="r")
        dirs = {}
        for tag in ("fw", "mirror"):
            a = {k: np.load(base / f"{tag}_{k}.npy",
                            mmap_mode="r" if k in ("bwt", "sa") else None)
                 for k in DIR_FIELDS}
            dirs[tag] = FmDirection(
                primary=int((base / f"{tag}_primary.txt").read_text()), **a)
    else:
        log(f"text of {n} bp")
        g = text_of(n)
        dirs, times = {}, {}
        for tag in ("fw", "mirror"):
            src = g if tag == "fw" else g[::-1].copy()
            t0 = time.time()
            sa = suffix_array(src)
            t1 = time.time()
            log(f"SA-IS ({tag}, {sa.dtype}) in {t1 - t0:.1f} s")
            dirs[tag] = _build_direction(src, sa)
            del sa, src
            times[tag] = dict(sa_s=t1 - t0, direction_s=time.time() - t1)
            log(f"direction {tag} built in {time.time() - t0:.1f} s")
        if cache:
            base.mkdir(parents=True, exist_ok=True)
            np.save(base / "joined.npy", g)
            for tag, d in dirs.items():
                for k in DIR_FIELDS:
                    np.save(base / f"{tag}_{k}.npy", getattr(d, k))
                (base / f"{tag}_primary.txt").write_text(str(d.primary))
            done.write_text("ok")
            log(f"index cached under {base}")
    idx = FmIndex(
        fw=dirs["fw"], mirror=dirs["mirror"], joined=g,
        run_joined_start=np.array([0], np.int64),
        run_ref_id=np.array([0], np.int32),
        run_ref_off=np.array([0], np.int64),
        ref_full=g, ref_full_start=np.array([0], np.int64),
        ref_lens=np.array([n], np.int64), ref_names=["big"])
    return idx, times


def make_reads(g, n_reads: int, seed: int = 5):
    """100 bp reads, half from anywhere and half from past 2^31 - 10^4
    (past the middle for a text that ends before it), 0-2 substitutions,
    half reverse complemented: (seqs, start, forward?)."""
    n = len(g)
    hi_lo = (1 << 31) - 10_000 if n > 1 << 31 else n // 2
    rng = np.random.default_rng(seed)
    start = np.concatenate([
        rng.integers(0, n - READ_LEN, n_reads // 2),
        rng.integers(hi_lo, n - READ_LEN, n_reads - n_reads // 2)])
    reads = np.stack([np.asarray(g[s : s + READ_LEN]) for s in start])
    for k in range(2):
        m = rng.integers(0, 3, n_reads) > k
        pos = rng.integers(0, READ_LEN, n_reads)
        reads[m, pos[m]] = rng.integers(0, 4, n_reads).astype(np.uint8)[m]
    rc = rng.random(n_reads) < 0.5
    reads[rc] = (3 - reads[rc])[:, ::-1]
    bases = np.frombuffer(b"ACGT", np.uint8)
    return [row.tobytes() for row in bases[reads]], start, ~rc


def device_gb(al) -> dict:
    """Bytes of the index's tensors on the device, in GB."""
    size = lambda t: t.numel() * t.element_size() / 1e9
    out = {tag: sum(size(t) for t in (fm.side, fm.mark, fm.sa_samp,
                                      fm.ftab_top, fm.ftab_bot))
           for tag, fm in (("fw", al.dev), ("mirror", al.dev_mirror))}
    di = al.candgen.didx
    out["joined"] = size(di.joined)
    out["joined_words"] = size(di.joined_words)
    return out


# kernels whose device time the profiled batch reports, by a part of their
# names in the profiler
PROFILED = {"fm_walk": "fm_walk_kernel", "fm_lf_step": "fm_lf_step_kernel",
            "fm_resolve": "fm_resolve_kernel", "sw_banded": "banded_kernel<"}


def profile_batch(al, batch) -> dict:
    """One batch under torch.profiler on the card: wall and device ms, the
    busy share, and each PROFILED kernel's launches and device ms (its
    tables, a direction's sides and marks, in HBM)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        al.align_batch(batch)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    out = dict(wall_ms=wall, device_ms=total,
               busy_share=total / wall if wall else None)
    for key, sym in PROFILED.items():
        mine = [e.time_range.elapsed_us() / 1e3 for e in ev if sym in e.name]
        out[key] = dict(launches=len(mine), ms=sum(mine),
                        ms_per_launch=sum(mine) / max(len(mine), 1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--n-reads", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from ..align.pipeline import UnpairedAligner
    from ..io.fastq import make_batch
    from ..ops import kernels
    mach = machine()
    card = (_run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]) if args.device == "cuda"
            else "cpu")
    t0 = time.time()
    idx, build = build_or_load(args.n, not args.no_cache)
    log(f"index ready in {time.time() - t0:.1f} s")
    t0 = time.time()
    # past BIG_THRESHOLD the aligner takes the big layout on its own; a
    # shorter text is forced onto it
    al = UnpairedAligner(idx, device=args.device,
                         force_big=None if args.n >= N else True)
    if not al.big:
        raise RuntimeError("the big layout did not switch on past 2^31")
    upload = time.time() - t0
    log(f"on the device (big={al.big}) in {upload:.1f} s: "
        f"{device_gb(al)}")
    seqs, start, fw = make_reads(idx.joined, args.n_reads)
    B = args.batch
    batches = [make_batch([f"b{i}" for i in range(lo, lo + B)],
                          seqs[lo : lo + B], [b"I" * READ_LEN] * B)
               for lo in range(0, len(seqs) - B + 1, B)]
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else lambda: None)
    t0 = time.time()
    outs = [al.align_batch(batches[0])]
    sync()
    warm = time.time() - t0
    kernels.reset_launches()
    t0 = time.time()
    outs += [al.align_batch(b) for b in batches[1:]]
    sync()
    dt = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    prof = (profile_batch(al, batches[-1]) if args.device == "cuda"
            else None)
    n_done = B * len(batches)
    aligned = np.zeros(n_done, bool)
    at = np.zeros(n_done, bool)
    for k, recs in enumerate(outs):
        for i in range(B):
            r = recs[i]
            j = k * B + i
            aligned[j] = r.aligned
            at[j] = r.aligned and r.pos == start[j] and r.fw == fw[j]
    past = start[:n_done] >= (1 << 31)
    out = dict(
        metric="big_index_reads_per_s", genome_bp=int(args.n),
        big=bool(al.big), reads_per_s=B * (len(batches) - 1) / dt,
        warmup_batch_s=warm, batch=B, batches=len(batches),
        aligned=float(aligned.mean()), origin=float(at.mean()),
        reads_past_2_31=int(past.sum()),
        origin_past_2_31=float(at[past].mean()) if past.any() else None,
        launches=launches, profiled_batch=prof, build=build,
        upload_s=upload,
        device_gb=device_gb(al),
        max_allocated_gb=(torch.cuda.max_memory_allocated() / 1e9
                          if args.device == "cuda" else None),
        host_max_rss_gb=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6,
        machine=dict(nproc=mach["nproc"],
                     disk_free_gb=mach["disk_free_gb"]),
        card=card)
    log(f"{out['reads_per_s']:.1f} reads/s; aligned {out['aligned']:.4f}; "
        f"at origin {out['origin']:.4f} ({out['reads_past_2_31']} reads "
        f"past 2^31: {out['origin_past_2_31']})")
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
