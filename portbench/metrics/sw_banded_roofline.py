"""The banded DP kernels' share (%) of their roofline
(`ops/csrc/sw_banded.cu` `banded_kernel` with the `banded_general_kernel`
launched after it, `ops/csrc/sw_banded_wide.cu` above K = 128), over the
`banded_dp` calls that started in the traced slice.

Work: each call's problems, each its read length (rows, at most the tile's)
times the band K, times the frozen count of operations a cell
(yardstick.banded_ops_per_cell); the least time is that over the frozen
int32 peak, or the call's bytes over HBM's rate where that is larger
(yardstick.banded_least_s). Time: the device time of the kernels those
calls launched, from the trace: on each card, the first launches of each
kernel that started after recording began, as many as the calls launched
there. The read lengths stay on the card until the slice has ended, so
the wrapper adds no synchronisation."""
import numpy as np

from portbench.yardstick import banded_least_s

PROBES = {"dp": "module:bowtie2_server_tpu_torch.align.candgen:banded_dp"}
# banded_dp(cfg, K, rd, mmpen, lens, band)
CAPTURE = {"dp": lambda a, k, out: (int(a[1]), int(a[2].shape[0]),
                                    bool(a[0].local), a[4])}
REGISTER_BAND_MAX = 128      # ops/sw_banded.py: the register kernel's top


def read(calls, ctx):
    tr = ctx.trace
    if tr is None or not calls["dp"]:
        return None
    least, dev_s = 0.0, 0.0
    by_dev: dict = {}
    for c in calls["dp"]:
        K, lq, local, lens = c.info
        least += banded_least_s(lens.cpu().numpy().astype(np.int64), lq, K,
                                local)
        names = (("banded_kernel<", "banded_general_kernel")
                 if K <= REGISTER_BAND_MAX else ("banded_wide_kernel",))
        for name in names:
            key = (lens.device.index or 0, name)
            by_dev[key] = by_dev.get(key, 0) + 1
    for (dev, name), n in by_dev.items():
        evs = sorted((a, b) for nm, d, a, b in tr.events
                     if d == dev and name in nm
                     and tr.origin + a / 1e6 >= tr.t_start)
        if len(evs) < n:
            return None
        dev_s += sum(b - a for a, b in evs[:n]) / 1e6
    if dev_s <= 0:
        return None
    return 100.0 * least / dev_s
