"""Carry device state and pipeline configs from the JAX package into the
port, through plain numpy values and ints (this module imports no JAX).

    # with the JAX package's DeviceIndex `didx`, DeviceCuckoo `dkm`, cfg:
    didx_t, dkm_t = state_from_numpy(
        {k: np.asarray(v) for k, v in didx._asdict().items()
         if k in INDEX_FIELDS},
        {k: np.asarray(v) for k, v in dkm._asdict().items()}, device,
        fw={k: np.asarray(v) for k, v in didx.fw._asdict().items()},
        mirror={k: np.asarray(v) for k, v in didx.mirror._asdict().items()})
    cfg_t = cfg_from_fields(cfg._asdict())

Tests use it to feed both packages identical inputs.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .align.candgen import CandGenCfg, DeviceIndex
from .index.kmer import DeviceCuckoo, DeviceKmer
from .ops.fm import DeviceFm
from .ops.sw import SwConfig

INDEX_FIELDS = ("joined", "joined_words", "run_starts", "run_ends")


def _put(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(device)


def fm_from_numpy(fm: Mapping[str, np.ndarray], device) -> DeviceFm:
    """The port's DeviceFm on `device` from numpy copies of the fields of
    the JAX package's small-index DeviceFm (side, cnt, sa, ftab_top,
    ftab_bot, n, primary)."""
    side = np.ascontiguousarray(fm["side"], np.uint32).view(np.int32)
    cnt = tuple(int(x) for x in np.asarray(fm["cnt"])[:4])
    return DeviceFm(side=_put(side, np.int32, device),
                    cnt=_put(np.asarray(cnt), np.int64, device),
                    sa=_put(fm["sa"], np.int32, device),
                    ftab_top=_put(fm["ftab_top"], np.int32, device),
                    ftab_bot=_put(fm["ftab_bot"], np.int32, device),
                    n=int(fm["n"]), primary=int(fm["primary"]),
                    cnt_host=cnt)


def state_from_numpy(index: Mapping[str, np.ndarray],
                     kmer: Mapping[str, np.ndarray], device, *,
                     fw: Mapping | None = None, mirror: Mapping | None = None
                     ) -> tuple[DeviceIndex, DeviceCuckoo | DeviceKmer]:
    """The port's DeviceIndex and seed table on `device`, from numpy
    copies of the JAX package's DeviceIndex fields (INDEX_FIELDS, and the
    fields of its fw and mirror DeviceFm, which the general shape reads)
    and of its DeviceCuckoo ('table', 'pos') or DeviceKmer
    ('bucket_start', 'keys', 'pos')."""
    put = lambda a, dtype: _put(a, dtype, device)
    didx = DeviceIndex(joined=put(index["joined"], np.uint8),
                       joined_words=put(index["joined_words"], np.int64),
                       run_starts=put(index["run_starts"], np.int32),
                       run_ends=put(index["run_ends"], np.int32),
                       fw=fm_from_numpy(fw, device) if fw else None,
                       mirror=(fm_from_numpy(mirror, device) if mirror
                               else None))
    if "table" in kmer:
        dkm = DeviceCuckoo(table=put(kmer["table"], np.int64),
                           pos=put(kmer["pos"], np.int32))
    else:
        dkm = DeviceKmer(bucket_start=put(kmer["bucket_start"], np.int64),
                         keys=put(kmer["keys"], np.int64),
                         pos=put(kmer["pos"], np.int32))
    return didx, dkm


def cfg_from_fields(fields: Mapping) -> CandGenCfg:
    """The port's CandGenCfg from a CandGenCfg's `_asdict()`; its `sw`
    may be any dataclass with SwConfig's fields (or a mapping). Fields the
    port does not read are dropped; a big-index config is refused."""
    if fields.get("big"):
        raise NotImplementedError(
            "big: not ported yet (ROADMAP Queue A item 12)")
    sw = fields["sw"]
    if not isinstance(sw, Mapping):
        sw = dataclasses.asdict(sw)
    kw = {k: v for k, v in fields.items() if k in CandGenCfg._fields}
    kw["sw"] = SwConfig(**sw)
    return CandGenCfg(**kw)
