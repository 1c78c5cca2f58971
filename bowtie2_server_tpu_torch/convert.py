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


def _put_u32(a, device):
    """uint32 values as the int32 tensor of their bit patterns."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32)).to(device)


def fm_from_numpy(fm: Mapping[str, np.ndarray], device) -> DeviceFm:
    """The port's DeviceFm on `device` from numpy copies of the fields of
    the JAX package's DeviceFm (side, cnt, sa, ftab_top, ftab_bot, n,
    primary; and mark, sa_samp and off_rate, which a big index uses)."""
    cnt = tuple(int(x) for x in np.asarray(fm["cnt"])[:4])
    off_rate = int(fm.get("off_rate", 0))
    big = dict(mark=_put_u32(fm["mark"], device),
               sa_samp=_put_u32(fm["sa_samp"], device),
               off_rate=off_rate) if off_rate else {}
    return DeviceFm(side=_put_u32(fm["side"], device),
                    cnt=_put(np.asarray(cnt), np.int64, device),
                    sa=_put_u32(fm["sa"], device),
                    ftab_top=_put_u32(fm["ftab_top"], device),
                    ftab_bot=_put_u32(fm["ftab_bot"], device),
                    n=int(fm["n"]), primary=int(fm["primary"]),
                    cnt_host=cnt, **big)


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
                       run_starts=put(index["run_starts"], np.int64),
                       run_ends=put(index["run_ends"], np.int64),
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
    port does not read are dropped."""
    sw = fields["sw"]
    if not isinstance(sw, Mapping):
        sw = dataclasses.asdict(sw)
    kw = {k: v for k, v in fields.items() if k in CandGenCfg._fields}
    kw["sw"] = SwConfig(**sw)
    return CandGenCfg(**kw)
