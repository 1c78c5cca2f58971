"""Build, load and count the port's hand-written CUDA kernels (ops/csrc/).

The sources are compiled by nvcc for sm_90a into ONE shared library with a
plain C interface, bound with ctypes: each `.cu` file is compiled to an
object by its own nvcc process (all started together), then the objects
are linked. The library is built at first use into `build/kernels/` beside
the package, under a name keyed by a hash of the sources and flags, so a
stale build is never loaded and a checkout builds its own.

Every C entry point launches on the stream it is given, allocates nothing
and returns `cudaGetLastError()`; `check` turns a nonzero code into an
exception. `LAUNCHES` counts kernel launches per kernel name: a wrapper
adds one where it launches, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset_launches(); bt2_sw_banded
# launches two kernels, counted as sw_banded and sw_banded_general
LAUNCHES = {"sw_banded": 0, "sw_banded_general": 0, "sw_banded_wide": 0,
            "sw_banded_tb": 0, "sw": 0, "alu_probe": 0, "fm_walk": 0,
            "fm_lf_step": 0, "fm_resolve": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> tuple[Path, str, float]:
    """(library path, compiler log, build seconds) — log is empty and
    seconds 0 when the library for these sources was already built."""
    srcs = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for s in srcs + sorted(_CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = _BUILD / f"libbt2kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, "", 0.0
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs = [str(Path(tmp) / (s.stem + ".o")) for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *_ARCH, *_FLAGS, "-c", str(s), "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for s, o in zip(srcs, objs)]
        logs = []
        failed = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate(timeout=600)
            logs.append(f"== {s.name}\n{out.decode(errors='replace')}")
            if p.returncode != 0:
                failed.append(s.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_so = str(Path(tmp) / "lib.so")
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp_so, *objs],
                              capture_output=True, timeout=300)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stderr.decode(errors="replace"))
        # rename into place: concurrent builds race harmlessly
        os.replace(tmp_so, so)
    return so, log, time.time() - t0


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        so, _, _ = build()
        lb = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cfg = [ci] * 7        # ma npen rdg_open rdg_ext rfg_open rfg_ext gapbar
        for fn in (lb.bt2_sw_banded, lb.bt2_sw_banded_wide):
            fn.restype = ci
            fn.argtypes = [vp] * 7 + [ci, ci, ci] + cfg + [ci, vp]
        lb.bt2_sw_banded_tb.restype = ci
        lb.bt2_sw_banded_tb.argtypes = [vp] * 9 + [ci] * 4 + cfg + [ci, vp]
        lb.bt2_sw.restype = ci
        lb.bt2_sw.argtypes = [vp] * 8 + [ci, ci, ci] + cfg + [ci, vp]
        lb.bt2_alu_probe.restype = ci
        lb.bt2_alu_probe.argtypes = [vp, vp, ci, ci, vp]
        lb.bt2_fm_walk.restype = ci
        lb.bt2_fm_walk.argtypes = [vp] * 13 + [ci] * 13 + [vp]
        lb.bt2_fm_lf_step.restype = ci
        lb.bt2_fm_lf_step.argtypes = [vp] * 6 + [ci] * 8 + [vp]
        lb.bt2_fm_resolve.restype = ci
        lb.bt2_fm_resolve.argtypes = [vp] * 6 + [ci] * 8 + [vp]
        _LIB = lb
    return _LIB


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {rc})")


def cfg_args(cfg) -> list[int]:
    """SwConfig as the C entry points' scoring arguments."""
    return [int(cfg.ma), int(cfg.npen), int(cfg.rdg_open), int(cfg.rdg_ext),
            int(cfg.rfg_open), int(cfg.rfg_ext), int(cfg.gapbar)]


def loop_mix(symbol: str, rank=None) -> tuple[int, dict[str, int]]:
    """Instruction mix of one loop (the span from a backward branch's
    target to the branch) of the kernel whose mangled name contains
    `symbol`, read from the SASS of the built library with the toolkit's
    cuobjdump: the largest loop, or the one for which rank(instructions,
    {opcode: count}) is largest. Loops holding ENDCOLLECTIVE are skipped:
    they are the compiler's fallback for warp shuffles it cannot prove
    converged, not the kernel's own loop. Returns (instructions in the
    loop, {opcode: count}); (0, {}) when no loop is found."""
    so, _, _ = build()
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    bodies = [f for f in sass.split("Function : ")[1:]
              if symbol in f.split("\n", 1)[0]]
    if not bodies:
        raise ValueError(f"no kernel matching {symbol!r} in {so.name}")
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", bodies[0])
    addrs = [int(a, 16) for a, _ in ins]
    best, best_key = (0, {}), None
    for n, (_, txt) in enumerate(ins):
        m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", txt)
        if not (m and int(m.group(1), 16) < addrs[n]
                and int(m.group(1), 16) in addrs):
            continue
        start = addrs.index(int(m.group(1), 16))
        if any("ENDCOLLECTIVE" in t for _, t in ins[start : n]):
            continue
        ops = [re.sub(r"^@!?U?P\w+\s+", "", t.strip()).split()[0]
               .split(".")[0] for _, t in ins[start : n + 1]]
        mix = Counter(o for o in ops if o != "NOP")
        count = sum(mix.values())
        key = rank(count, mix) if rank else count
        if best_key is None or key > best_key:
            best, best_key = (count, dict(mix.most_common())), key
    return best
