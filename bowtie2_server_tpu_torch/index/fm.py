"""TPU-oriented FM-index data model (ref: bt2_idx.h:544 `Ebwt`, reference.h:59).

Differences from the reference's .bt2 layout, by design for TPU:

- BWT stored as one byte per base (uint8, values 0-3, 4 at the primary row)
  instead of 2-bit packed 64-byte "sides": device-side in-block counting is a
  vectorized compare+sum over a gathered block, so byte layout trades 4x HBM
  footprint for simple coalesced gathers (2-bit packing + popcount is a later
  optimization, see ops/fm.py).
- Occ checkpoints every OCC_BLOCK rows as a [n_blocks+1, 4] uint32 table
  (ref: embedded per-side checkpoints, bt2_idx.h:112-166).
- The FULL suffix array is kept (uint32; uint64 beyond 4 Gbp) instead of an
  offRate-sampled SA: SA resolution becomes a single device gather, replacing
  the whole lazy group-walk subsystem (ref: group_walk.h:1086 GroupWalk2S,
  bt2_idx.h:1607 walkLeft). HBM capacity (4 B/bp) buys away a latency-bound
  pointer chase that would serialize terribly on TPU.
- ftab: k-mer -> row-range jump table like the reference's (ref:
  bt2_idx.h:1476 ftabLoHi, ftabChars=10), stored as two flat uint32 arrays.

Reference-genome storage (ref: reference.h BitPairReference, .3/.4.bt2):
- `joined`: the concatenation of all unambiguous runs (codes 0-3) — the text
  the FM index is built over;
- run tables mapping joined offsets -> (reference id, reference offset), the
  equivalent of RefRecords + `joinedToTextOff` (ref: bt2_idx.h:1728);
- `ref_full`: every reference base including ambiguous ones as code 4, with
  per-reference start offsets — the DP window source, playing the role of
  BitPairReference::getStretch.

Both search directions are kept: `fw` over `joined`, and `mirror` over the
reversed text (ref: the .rev.1/.rev.2 mirror index), enabling bidirectional
search for the 1-mismatch stages.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

OCC_BLOCK = 128          # BWT rows per occ checkpoint
FTAB_CHARS = 10          # k-mer length of the jump table (ref: bt2_idx.h ftabChars)


@dataclass
class FmDirection:
    """One search direction: BWT + occ + full SA (+ ftab)."""
    bwt: np.ndarray          # [n] uint8, 0..3 (4 at primary row)
    occ: np.ndarray          # [n_blocks+1, 4] uint32 cumulative counts
    cnt: np.ndarray          # [5] int64: C array, cnt[c] = #chars < c; cnt[4] = n
    sa: np.ndarray           # [n] uint32/uint64 full suffix array
    primary: int             # row whose suffix starts at text position 0
    ftab_top: np.ndarray     # [4^FTAB_CHARS] uint32
    ftab_bot: np.ndarray     # [4^FTAB_CHARS] uint32

    @property
    def n(self) -> int:
        return int(self.bwt.shape[0])


@dataclass
class FmIndex:
    """The full index: both directions plus reference geometry."""
    fw: FmDirection
    mirror: FmDirection | None
    joined: np.ndarray          # [n] uint8 unambiguous joined text
    # Unambiguous run tables (RefRecord equivalent), one entry per run:
    run_joined_start: np.ndarray  # [R] joined start offset of run (sorted)
    run_ref_id: np.ndarray        # [R] reference index of run
    run_ref_off: np.ndarray       # [R] offset of run within its reference
    # Full reference including Ns:
    ref_full: np.ndarray        # [total_ref_len] uint8 codes 0..4
    ref_full_start: np.ndarray  # [n_refs] start of each ref within ref_full
    ref_lens: np.ndarray        # [n_refs] reference lengths (incl. Ns)
    ref_names: list[str]
    # disk location this index was loaded from (None for in-memory
    # builds); derived caches (the seed k-mer table) key off it
    cache_base: str | None = None

    @property
    def n(self) -> int:
        return int(self.joined.shape[0])

    @property
    def n_refs(self) -> int:
        return len(self.ref_names)

    # ---- coordinate translation (ref: bt2_idx.h:1728 joinedToTextOff) ----

    def joined_to_ref(self, joined_off, aln_len=None):
        """Vectorized joined offset -> (ref_id, ref_off, valid).

        If aln_len is given, alignments that straddle an unambiguous-run
        boundary are marked invalid (the reference rejects straddlers)."""
        joined_off = np.asarray(joined_off)
        idx = np.searchsorted(self.run_joined_start, joined_off, side="right") - 1
        idx = np.clip(idx, 0, len(self.run_joined_start) - 1)
        base = self.run_joined_start[idx]
        within = joined_off - base
        ref_id = self.run_ref_id[idx]
        ref_off = self.run_ref_off[idx] + within
        valid = joined_off >= 0
        if aln_len is not None:
            run_end = np.append(self.run_joined_start[1:], self.n)[idx]
            valid = valid & (joined_off + aln_len <= run_end)
        return ref_id, ref_off, valid

    def get_ref_stretch(self, ref_id: int, start: int, length: int) -> np.ndarray:
        """Reference window with out-of-bounds padded as N (code 4)
        (ref: reference.cpp getStretch pads/marks off-end)."""
        out = np.full(length, 4, dtype=np.uint8)
        rlen = int(self.ref_lens[ref_id])
        lo = max(0, start)
        hi = min(rlen, start + length)
        if hi > lo:
            s = int(self.ref_full_start[ref_id])
            out[lo - start : hi - start] = self.ref_full[s + lo : s + hi]
        return out

    # ---- persistence (our native on-disk format: a single .npz + json) ----

    def save(self, base: str | Path) -> None:
        base = Path(base)
        arrs = dict(
            joined=self.joined,
            run_joined_start=self.run_joined_start,
            run_ref_id=self.run_ref_id,
            run_ref_off=self.run_ref_off,
            ref_full=self.ref_full,
            ref_full_start=self.ref_full_start,
            ref_lens=self.ref_lens,
        )
        for name, d in (("fw", self.fw), ("mirror", self.mirror)):
            if d is None:
                continue
            arrs[f"{name}_bwt"] = d.bwt
            arrs[f"{name}_occ"] = d.occ
            arrs[f"{name}_cnt"] = d.cnt
            arrs[f"{name}_sa"] = d.sa
            arrs[f"{name}_primary"] = np.array([d.primary], dtype=np.int64)
            arrs[f"{name}_ftab_top"] = d.ftab_top
            arrs[f"{name}_ftab_bot"] = d.ftab_bot
        np.savez(str(base) + ".fm.npz", **arrs)
        meta = {"version": 1, "ref_names": self.ref_names,
                "occ_block": OCC_BLOCK, "ftab_chars": FTAB_CHARS}
        Path(str(base) + ".fm.json").write_text(json.dumps(meta))

    @staticmethod
    def load(base: str | Path) -> "FmIndex":
        base = str(base)
        z = np.load(base + ".fm.npz")
        meta = json.loads(Path(base + ".fm.json").read_text())

        def load_dir(name: str) -> FmDirection | None:
            if f"{name}_bwt" not in z:
                return None
            return FmDirection(
                bwt=z[f"{name}_bwt"], occ=z[f"{name}_occ"], cnt=z[f"{name}_cnt"],
                sa=z[f"{name}_sa"], primary=int(z[f"{name}_primary"][0]),
                ftab_top=z[f"{name}_ftab_top"], ftab_bot=z[f"{name}_ftab_bot"])

        return FmIndex(
            fw=load_dir("fw"), mirror=load_dir("mirror"),
            joined=z["joined"],
            run_joined_start=z["run_joined_start"],
            run_ref_id=z["run_ref_id"], run_ref_off=z["run_ref_off"],
            ref_full=z["ref_full"], ref_full_start=z["ref_full_start"],
            ref_lens=z["ref_lens"], ref_names=list(meta["ref_names"]),
            cache_base=base)


# ---- host-side scalar FM ops: the correctness oracle for device kernels ----

def occ_at(d: FmDirection, c: int, row: int) -> int:
    """#occurrences of char c in bwt[0:row] via checkpoint + tail count."""
    blk = row // OCC_BLOCK
    cnt = int(d.occ[blk, c])
    tail = d.bwt[blk * OCC_BLOCK : row]
    return cnt + int(np.count_nonzero(tail == c))


def lf_range(d: FmDirection, c: int, top: int, bot: int) -> tuple[int, int]:
    """One backward-search step: extend pattern by char c on the left."""
    new_top = int(d.cnt[c]) + occ_at(d, c, top)
    new_bot = int(d.cnt[c]) + occ_at(d, c, bot)
    return new_top, new_bot


def search_exact(d: FmDirection, pattern: np.ndarray) -> tuple[int, int]:
    """Backward search of the full pattern; returns [top, bot) row range."""
    top, bot = 0, d.n
    for ch in pattern[::-1]:
        if ch > 3:
            return 0, 0
        top, bot = lf_range(d, int(ch), top, bot)
        if top >= bot:
            return 0, 0
    return top, bot
