"""Carry device state and pipeline configs from the JAX package into the
port, through plain numpy values and ints (this module imports no JAX).

    # with the JAX package's DeviceIndex `didx`, DeviceCuckoo `dkm`, cfg:
    didx_t, dkm_t = state_from_numpy(
        {k: np.asarray(v) for k, v in didx._asdict().items()
         if k in INDEX_FIELDS},
        {k: np.asarray(v) for k, v in dkm._asdict().items()}, device)
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
from .ops.sw import SwConfig

INDEX_FIELDS = ("joined", "joined_words", "run_starts", "run_ends")


def state_from_numpy(index: Mapping[str, np.ndarray],
                     kmer: Mapping[str, np.ndarray], device
                     ) -> tuple[DeviceIndex, DeviceCuckoo | DeviceKmer]:
    """The port's DeviceIndex and seed table on `device`, from numpy
    copies of the JAX package's DeviceIndex fields (INDEX_FIELDS; others
    such as the device FM index are not needed) and of its DeviceCuckoo
    ('table', 'pos') or DeviceKmer ('bucket_start', 'keys', 'pos')."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(
            device)

    didx = DeviceIndex(joined=put(index["joined"], np.uint8),
                       joined_words=put(index["joined_words"], np.int64),
                       run_starts=put(index["run_starts"], np.int32),
                       run_ends=put(index["run_ends"], np.int32))
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
    fast shape does not read are dropped; a config of a shape the port
    does not have (short reads, big index, -N 1) is refused."""
    for name, item in (("has_short", 10), ("big", 12), ("seed_mms", 10)):
        if fields.get(name):
            raise NotImplementedError(
                f"{name}: not ported yet (ROADMAP Queue A item {item})")
    sw = fields["sw"]
    if not isinstance(sw, Mapping):
        sw = dataclasses.asdict(sw)
    kw = {k: v for k, v in fields.items() if k in CandGenCfg._fields}
    kw["sw"] = SwConfig(**sw)
    return CandGenCfg(**kw)
