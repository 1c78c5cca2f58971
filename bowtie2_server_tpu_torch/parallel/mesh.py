"""Read-sharded data parallelism over a 'dp' mesh of torch devices (port of
bowtie2_server_tpu/parallel/mesh.py; ref: §2.3 of the survey — the
reference's only parallel axis is read-level data parallelism over
threads).

A `Mesh` is an ordered list of torch devices on one axis named 'dp'. Reads
are split along it in equal blocks, one block a device, and the index is
replicated: it is held once on each distinct device of the mesh. One
process drives every device, as the JAX program has one controller: each
shard is enqueued under its own device (`device_scope`), and the host
waits only when it reads the results. A mesh may name one device more than
once (`Mesh([cuda:0] * 4)`, `Mesh([cpu] * 8)`): its shards then share that
device, in turns, and hold the index there once. These logical shards are
the port's counterpart of the virtual CPU devices the JAX tests run on;
their output equals a mesh of as many cards.

`device_align_step` is the small fused step of the JAX module: exact FM
search, the first hit's SA offset, the band gather and the banded DP.
`make_sharded_step` runs it over a mesh, with the aligned count summed over
the shards onto the first device (the counterpart of the psum).
`dryrun_multichip` and `dryrun_full_pipeline` drive the step and the real
UnpairedAligner over a mesh and check them.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import fm as dfm
from ..ops.sw import SwConfig
from ..ops.sw_banded import banded_dp


class Mesh:
    """An ordered list of devices on the one axis 'dp': all CPU, or all
    cards, each named by its index. A device may repeat."""

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) > 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"a mesh is all CPU or all cards, not {devs}")
        if any(d.type == "cuda" and d.index is None for d in devs):
            raise ValueError(f"a mesh names each card by its index: {devs}")
        self.devices = devs

    @property
    def size(self) -> int:
        """Shards: the number of devices, repeats included."""
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The distinct devices, in mesh order: each holds the replicated
        state once."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self):
        return f"Mesh('dp': {[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, *, device="cuda") -> Mesh:
    """A mesh over the first n_devices cards (default: every card), as the
    JAX `make_mesh` takes the first n devices. A device that names one
    device ('cuda:k', 'cpu') gives n_devices logical shards on it
    (default 1)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"a mesh of {n} cards needs {n} cards "
                             f"(have {count})")
        return Mesh([torch.device("cuda", k) for k in range(n)])
    return Mesh([device] * (n_devices or 1))


def device_scope(device):
    """The context under which a shard's work is enqueued: its card made
    current (copies, launches, events and the current stream all follow
    the current card); nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def tree_map(fn, tree):
    """fn applied to each tensor of a tensor, or of a NamedTuple of them
    (nested); other fields are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return tree


def replicate(tree, device):
    """A tree of tensors (`tree_map`) on `device`: tensors already there
    are shared, not copied."""
    return tree_map(lambda t: t.to(device), tree)


# ---- the small fused step ---------------------------------------------------

def device_align_step(cfg: SwConfig, K: int, fm: dfm.DeviceFm, joined,
                      reads, lens, mmpen):
    """One fused alignment step on the device of `fm` (a small index: full
    SA): [B, L] read codes -> per-read best banded DP score along the first
    exact hit's diagonal, and that hit's joined offset (-1: no hit). On a
    card this launches `fm_walk` (SEARCH, no ftab) and the banded kernel at
    K. Returns int32 (best, offs) [B]."""
    B, L = reads.shape
    dev = reads.device
    top, bot = dfm.backward_search_body(fm, reads, lens, use_ftab=False)
    rows = top.to(torch.int64).clamp(0, fm.sa.shape[0] - 1)
    offs = torch.where(bot - top > 0, fm.sa[rows], -1).to(torch.int32)
    diag = offs.clamp_min(0).to(torch.int64)
    cols = (diag[:, None] - K // 2
            + torch.arange(L + K, device=dev)[None, :])
    n = joined.shape[0]
    band = torch.where((cols >= 0) & (cols < n),
                       joined[cols.clamp(0, n - 1)].to(torch.int32), 4)
    t32 = lambda a: a.to(torch.int32).T.contiguous()
    best, _, _ = banded_dp(cfg, K, t32(reads), t32(mmpen),
                           lens.to(torch.int32).contiguous(), t32(band))
    return best, offs


def make_sharded_step(mesh: Mesh, cfg: SwConfig, K: int):
    """The step over the mesh: reads, lens and mmpen split in equal blocks
    along 'dp', the index and text replicated on each distinct device
    (copied once per source pair, then reused), `best`/`offs` concatenated
    and the aligned count summed over the shards, all on the first device.
    step(fm, joined, reads, lens, mmpen, minsc) -> (best, offs,
    n_aligned)."""
    first = mesh.devices[0]
    replicas: dict = {}

    def replica(dev, fm, joined):
        hit = replicas.get(dev)
        if hit is None or hit[0] is not fm or hit[1] is not joined:
            hit = replicas[dev] = (fm, joined, replicate(fm, dev),
                                   joined.to(dev))
        return hit[2], hit[3]

    def step(fm, joined, reads, lens, mmpen, minsc: int):
        B = reads.shape[0]
        if B % mesh.size:
            raise ValueError(f"{B} reads do not split into {mesh.size} "
                             f"equal shards")
        Bl = B // mesh.size
        best_l, offs_l, n_l = [], [], []
        for s, dev in enumerate(mesh.devices):
            with device_scope(dev):
                fm_d, joined_d = replica(dev, fm, joined)
                sl = slice(s * Bl, (s + 1) * Bl)
                best, offs = device_align_step(
                    cfg, K, fm_d, joined_d, reads[sl].to(dev),
                    lens[sl].to(dev), mmpen[sl].to(dev))
                n_l.append((best >= minsc).sum(dtype=torch.int32))
            best_l.append(best)
            offs_l.append(offs)
        cat = lambda ts: torch.cat([t.to(first) for t in ts])
        n_aligned = torch.stack([n.to(first) for n in n_l]).sum(
            dtype=torch.int32)
        return cat(best_l), cat(offs_l), n_aligned

    return step


# ---- dry runs ---------------------------------------------------------------

def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Build an n-device mesh (`make_mesh(n_devices, device=device)`), run
    the sharded step once on tiny shapes, and check that every read
    aligned."""
    from ..index.build import build_index
    from ..utils import dna
    mesh = make_mesh(n_devices, device=device)
    first = mesh.devices[0]
    cfg = SwConfig()
    K = 32
    B, L = 8 * mesh.size, 32
    rng = np.random.default_rng(0)
    text = dna.decode(rng.integers(0, 4, 2048).astype(np.uint8))
    idx = build_index(f">r\n{text}\n", both_directions=False)
    fm = dfm.to_device(idx.fw, first)
    joined = torch.from_numpy(idx.joined).to(first)
    reads = np.zeros((B, L), np.uint8)
    for b in range(B):
        s = rng.integers(0, idx.n - L)
        reads[b] = idx.joined[s : s + L]
    lens = np.full(B, L, np.int32)
    mmpen = np.full((B, L), 6, np.int32)
    step = make_sharded_step(mesh, cfg, K)
    best, offs, n_aligned = step(
        fm, joined, *(torch.from_numpy(a) for a in (reads, lens, mmpen)),
        -100)
    _check(int(n_aligned) == B, f"{int(n_aligned)} != {B}")
    _check(tuple(best.shape) == (B,), f"best has shape {tuple(best.shape)}")


def dryrun_full_pipeline(n_devices: int, device="cuda") -> None:
    """Drive the real UnpairedAligner (exact, 1-mismatch, seeds, DP,
    selection) over an n-device mesh and check that its records equal the
    first device's alone."""
    from ..align.pipeline import UnpairedAligner
    from ..index.build import build_index
    from ..io.fastq import make_batch
    from ..utils import dna
    mesh = make_mesh(n_devices, device=device)
    rng = np.random.default_rng(7)
    text = dna.decode(rng.integers(0, 4, 20000).astype(np.uint8))
    idx = build_index(f">chr\n{text}\n")
    B, L = 8 * mesh.size, 50
    names, seqs, quals = [], [], []
    for b in range(B):
        s = rng.integers(0, idx.n - L)
        rd = idx.joined[s : s + L].copy()
        if b % 3 == 0:
            rd[rng.integers(0, L)] = rng.integers(0, 4)
        if b % 2 == 0:
            rd = dna.revcomp(rd)
        names.append(f"r{b}")
        seqs.append(dna.decode(rd).encode())
        quals.append(b"I" * L)
    batch = make_batch(names, seqs, quals)
    recs_m = UnpairedAligner(idx, mesh=mesh).align_batch(batch)
    recs_1 = UnpairedAligner(idx, device=mesh.devices[0]).align_batch(batch)
    _check(len(recs_m) == len(recs_1), f"{len(recs_m)} != {len(recs_1)}")
    n_aligned = 0
    for rm, r1 in zip(recs_m, recs_1):
        t_m = (rm.aligned, rm.fw, rm.ref_id, rm.pos, rm.score, rm.cigar,
               rm.md, rm.mapq)
        t_1 = (r1.aligned, r1.fw, r1.ref_id, r1.pos, r1.score, r1.cigar,
               r1.md, r1.mapq)
        _check(t_m == t_1, f"{rm.name}: {t_m} != {t_1}")
        n_aligned += rm.aligned
    _check(n_aligned >= B * 3 // 4, f"only {n_aligned}/{B} aligned")
