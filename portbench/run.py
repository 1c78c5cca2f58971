"""One run of one cell of the port's benchmark:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for
(BENCHMARK.json). It builds the cell's genome and its index once into
`tmp/portbench/` of the checkout (as bowtie2-build would, offline), serves
the index with the port's BT2SRV server in this process, warms the cell's
batch shapes through the socket, then lets the load's own process (the
cell's clients) load the server for `--seconds` seconds. After the window
it reads the cards' memory peak, stops the server, and holds a sample of
the answers, drawn from the seed, against the plain reference
(reference.py).

Standard output's last line is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, with --trace 1 a breakdown, and
last `checks`: each number compared with its limit. The numbers compared
are the keys of the cell's limits file (`portbench/limits/<cell>.json`),
which has to name every number the cell's judge gives
(`reference.number_names`): a number with no limit, a key the judge gives
no number for, or a share whose base is 0, fails the run. The same
numbers are standard error's last lines. A run without the cards the cell
needs, or that finds JAX or the JAX package loaded, prints no result and
exits 2.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path

from . import genome as gmod
from . import probes
from .traffic import (ReadSource, load_config, load_traffic,
                      records_per_row)
from .wire import Connection

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "tmp" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "bowtie2_server_tpu")


@dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict


def resolve_cell(bench: dict, name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic,
    limits and metrics, found by name."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    pl = [m for m in bench["per_layer"]
          if (name in m["workloads"] if "workloads" in m
              else m["moves"] in reported)]
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name, load_config(w["config"]), load_traffic(w["traffic"]),
                int(w["chips"]), e2e, pl, limits)


def process_start() -> float:
    """Wall-clock time this process started (/proc), else when run.py was
    imported."""
    try:
        stat = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(stat[19])
        btime = next(int(ln.split()[1]) for ln in
                     Path("/proc/stat").read_text().splitlines()
                     if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------- the genome -

def genome_dir(cfg: dict) -> Path:
    """The configuration's genome and index, built once into the
    checkout's cache (a fixed path keyed by the configuration and the
    simulator) and loaded from there after."""
    d = CACHE / f"{cfg['name']}-{gmod.config_key(cfg)}"
    if (d / "done").exists():
        return d
    from bowtie2_server_tpu_torch.index.build import build_index
    d.mkdir(parents=True, exist_ok=True)
    gen = gmod.make_genome(cfg)
    gmod.save_genome(gen, d)
    fa = d / "genome.fa"
    fa.write_bytes(gen.fasta())
    build_index(str(fa)).save(str(d / "genome"))
    fa.unlink()
    (d / "done").write_text("")
    return d


# ----------------------------------------------------------------- warm-up -

def warm_up(cell: Cell, gen, port: int, index_name: str, seed: int):
    """Send the cell's batch shape through the socket: `warmup_rows`
    reads, whole packs. Returns the wire's faults (a run with any is not
    correct)."""
    tr = cell.traffic
    src = ReadSource(gen, cell.cfg, tr, seed, 0, purpose=1)
    rows, _ = src.chunk(int(tr["warmup_rows"]))
    c = Connection("127.0.0.1", port, index_name,
                   records_per_row(cell.cfg))
    c.send(rows)
    c.finish(float(tr["drain_s"]))
    return sum(c.faults.values())


# ----------------------------------------------------------------- clients -

def split_cores():
    """(the server's cores, the load's cores): the load takes the last
    quarter of this process's cores (at least one), the server the rest,
    so that the clients' parsing does not take the server's."""
    cores = sorted(os.sched_getaffinity(0))
    k = max(1, len(cores) // 4)
    if len(cores) < 2:
        return cores, cores
    return cores[:-k], cores[-k:]


def start_clients(cell, seed, seconds, port, index_name, gdir, tmp,
                  cores=None):
    """The load's one process, pinned to `cores`; waits for its `ready`."""
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    spec = dict(host="127.0.0.1", port=port, index_name=index_name,
                config=cell.cfg, traffic=cell.traffic, seed=seed,
                seconds=seconds, genome_dir=str(gdir),
                result=str(tmp / "clients.json"))
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    pin = (lambda: os.sched_setaffinity(0, cores)) if cores else None
    procs = [subprocess.Popen(
        [sys.executable, "-m", "portbench.client_proc", str(path)],
        cwd=str(ROOT), env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True, preexec_fn=pin)]
    for k, p in enumerate(procs):
        line = p.stdout.readline().strip()
        if line != "ready":
            stop_all(procs)
            raise RuntimeError(f"client {k} did not start: {line!r}")
    return procs


def stop_all(procs, timeout: float = 0.0):
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


# -------------------------------------------------------------- the window -

def device_info(device: str, n: int):
    import torch
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": n}
    return {"platform": "cpu", "kind": "cpu", "count": n}


def memory_peak(device: str, n: int) -> int:
    import torch
    if not device.startswith("cuda"):
        return 0
    return max(torch.cuda.max_memory_allocated(k) for k in range(n))


def synchronize(device: str, n: int):
    import torch
    if device.startswith("cuda"):
        for k in range(n):
            torch.cuda.synchronize(k)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", prepare=None, hook=None,
             load_cores=None) -> tuple[dict, list[str]]:
    """One run. Returns (the result object, the lines of the checks).
    prepare(), before the server is built, and hook(served), once it is
    up: the harness's tests break the timed path with them;
    load_cores: the cores of the load's process (main pins this process
    to the others)."""
    import torch
    import bowtie2_server_tpu_torch  # noqa: F401  (fails without the port)
    n_dev = int(cell.chips) if device.startswith("cuda") else 1
    tr = cell.traffic
    t_proc = process_start()
    gdir = genome_dir(cell.cfg)
    gen = gmod.load_genome(gdir)
    _progress(t_proc, "genome and index ready")
    from .server_proc import Served
    if prepare is not None:
        prepare()
    served = Served(str(gdir / "genome"), device, int(tr["workers"]))
    _progress(t_proc, "server listening")
    if hook is not None:
        hook(served)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    procs = []
    try:
        warm_faults = warm_up(cell, gen, served.port, served.index_name,
                              seed)
        _progress(t_proc, "warm-up answered")
        readers, rec, prof = {}, None, None
        if trace:
            readers = {m["name"]: probes.load_reader(m["name"])
                       for m in cell.per_layer}
            rec = probes.install(served.srv, readers)
            if device.startswith("cuda"):
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CUDA]):
                    torch.zeros(1, device="cuda").add_(1)
                prof = profile(activities=[ProfilerActivity.CUDA])
        if device.startswith("cuda"):
            for k in range(n_dev):
                torch.cuda.reset_peak_memory_stats(k)
        procs = start_clients(cell, seed, seconds, served.port,
                              served.index_name, gdir, tmp, load_cores)
        _progress(t_proc, "clients ready")
        t0 = time.monotonic() + 0.5
        t_end = t0 + seconds
        wall0 = time.time() + (t0 - time.monotonic())
        setup_s = wall0 - process_start()
        for p in procs:
            p.stdin.write(f"go {t0!r} {t_end!r}\n")
            p.stdin.flush()
        t_start = t_stop = None
        if trace:
            lead = min(1.0, 0.1 * seconds)
            _sleep_until(t0 + lead)
            if prof is not None:
                prof.start()
            t_start = time.time()
            rec.on = True
            _sleep_until(t_end - 0.25)
            rec.on = False
            t_stop = time.time()
            synchronize(device, n_dev)
            if prof is not None:
                prof.stop()
        stop_all(procs, seconds + float(tr["drain_s"]) + 60)
        mem = memory_peak(device, n_dev)
        layer, breakdown, busy = {}, None, None
        if trace:
            ctx = Ctx(cell, n_dev, t_start, t_stop, prof)
            for name, mod in readers.items():
                v = mod.read(probes.calls_for(rec, name, mod), ctx)
                if v is not None:
                    layer[name] = v
            if ctx.trace is not None:
                busy = ctx.trace.busy_s(n_dev)
                breakdown = make_breakdown(ctx.trace, rec)
        path = tmp / "clients.json"
        results = json.loads(path.read_text()) if path.exists() else []
        if len(results) != int(tr["clients"]):
            results.append(None)        # a client that wrote nothing
    finally:
        stop_all(procs)
        served.close()
        for f in tmp.glob("*"):
            f.unlink()
        tmp.rmdir()
    del served
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return finish(cell, gen, results, seconds, setup_s, mem, layer,
                  breakdown, busy, t_start, t_stop, device, n_dev, trace,
                  warm_faults)


class Ctx:
    def __init__(self, cell, n_dev, t_start, t_stop, prof):
        from .yardstick import Trace
        self.cfg = cell.cfg
        self.n_devices = n_dev
        self.t_start, self.t_stop = t_start, t_stop
        self.trace = Trace(prof, t_start, t_stop) if prof is not None \
            else None


def make_breakdown(tr, rec) -> dict:
    """The device operations that took most time, and the longest idle
    gaps on the first card, each named by the innermost traced call that
    was running at its middle (on any thread)."""
    calls = [(c.t0, c.t1, target) for target, cs in rec.calls.items()
             for c in cs]
    gaps = sorted(tr.gaps(min(tr.busy) if tr.busy else 0),
                  key=lambda g: -g[1])[:10]
    named = []
    for start, s in gaps:
        mid = start + s / 2
        inner = [(t1 - t0, target) for t0, t1, target in calls
                 if t0 <= mid <= t1]
        named.append([min(inner)[1] if inner else "no traced call", s])
    return {"device_ops": tr.top_ops(10), "idle_gaps": named}


def _progress(t_proc: float, what: str):
    print(f"setup: {what} at {time.time() - t_proc:.2f} s", file=sys.stderr,
          flush=True)


def _sleep_until(t: float):
    while (d := t - time.monotonic()) > 0:
        time.sleep(min(d, 0.05))


def finish(cell, gen, results, seconds, setup_s, mem, layer, breakdown,
           busy, t_start, t_stop, device, n_dev, trace, warm_faults=0):
    """The result object and the checks' lines of a run, from what the
    clients wrote (`results`, an entry a client, None for one that wrote
    nothing) and what the run read."""
    from .reference import Judge, number_names, numbers
    lost = sum(r is None for r in results)
    results = [r for r in results if r is not None]
    faults: dict[str, int] = {}
    for r in results:
        for k, v in r["faults"].items():
            faults[k] = faults.get(k, 0) + v
    samples = [s for r in results for s in r["samples"]]
    verdict = Judge(cell.cfg, gen).judge(samples)
    judge_faults = verdict.pop("faults", None)
    unanswered = (faults.get("unanswered", 0) + faults.get("stray", 0)
                  + faults.get("miscounted", 0) + faults.get("no_all_done", 0)
                  + faults.get("refused", 0) + verdict["missing"]
                  + warm_faults + 1000000 * lost)
    # every number the limits file names is compared with its limit; one
    # the judge does not give, one of the judge's with no limit, or a share
    # of nothing, fails the run
    known = {"unanswered": (unanswered, None), **numbers(verdict)}
    checks, unjudged = {}, []
    for k, lim in cell.limits.items():
        v, base = known.get(k, (None, None))
        checks[k] = {"value": v, "limit": lim["limit"]}
        if v is None:
            unjudged.append(f"checks: {k} has a limit, but the judge gives "
                            f"no such number for this cell")
        elif base == 0:
            unjudged.append(f"checks: {k} is a share of nothing: the "
                            f"sample held no case of it")
    for k in sorted(number_names(cell.cfg) - set(cell.limits)):
        checks[k] = {"value": known[k][0], "limit": None}
        unjudged.append(f"checks: {k} is a number of this cell's judge, but "
                        f"its limits file gives it no limit")
    correct = not unjudged and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    lines = [f"judged {verdict['judged']} reads of {len(samples)} sampled "
             f"answers: {verdict['below']} below their origin's best "
             f"({verdict['unaligned']} of them unaligned); "
             f"{verdict['gapped']} whose best needs a gap, "
             f"{verdict['gapped_below']} of them below it; "
             f"{verdict['repeat']} repeat reads with a second alignment, "
             f"{verdict['repeat_short']} of them with XS missing or below it"]
    if "pairs" in verdict:
        lines.append(
            f"judged {verdict['pairs']} pairs: {verdict['concordant']} "
            f"reported concordant, {verdict['pair_faults']} with pair "
            f"fields unlike the recomputation; {verdict['pair_held']} "
            f"concordant in truth with valid bests, "
            f"{verdict['pair_below']} of them reported not concordant or "
            f"below their mates' bests")
    lines += unjudged
    lines += [f"checks: {k} {c['value']} (limit {c['limit']})"
              for k, c in checks.items()]
    answered = sum(r["answered"] for r in results)
    attempted, failed = answered + unanswered, unanswered
    e2e = {}
    for m in cell.end_to_end:
        if m["name"] == "setup_s":
            v = setup_s
        elif m["name"] == "reads_per_s":
            # every read answered inside the window (a pair's mates
            # count as two), over its length
            v = sum(r["in_window"] for r in results) / seconds
        else:
            continue
        e2e[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = device_info(device, n_dev)
    dev["memory_peak_bytes"] = mem
    lines.insert(0, f"memory peak {mem} bytes on the fullest card")
    if trace:
        metrics = {m["name"]: {"value": layer[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in layer}
        dev["busy_s"] = busy if busy is not None else 0.0
        dev["window_s"] = t_stop - t_start
    else:
        metrics = e2e
        for k, v in e2e.items():
            lines.insert(0, f"{k} {v['value']} {v['unit']}")
    if judge_faults:
        lines[:0] = judge_faults[:5]
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out, lines


LOAD_CORES = None


def pin_server():
    """Pin this process, before it starts a thread, to the server's cores;
    the load's process gets the others."""
    global LOAD_CORES
    server, load = split_cores()
    if server != load:
        os.sched_setaffinity(0, server)
        LOAD_CORES = load


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = resolve_cell(bench, a.workload)
    pin_server()
    # the program's kernel caches stay inside the checkout, at fixed paths
    # (its own kernels build into bowtie2_server_tpu_torch/build/)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    out, lines = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                          load_cores=LOAD_CORES)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the run must not load: {bad}",
              file=sys.stderr)
        return 2
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
