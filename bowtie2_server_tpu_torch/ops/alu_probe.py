"""Int32 ALU-ceiling probe of the DP microbench (scripts/bench_dp.py of
this package). Port of the probe kernel of the reference's
scripts/bench_dp.py (`_measure_alu_ceiling.kern`).

The probe is a dependent max/add chain, elementwise over an int32 tile:
    y = x + 1
    for i in range(nsteps):  x = max(x + i, y);  y = max(y + 2, x)
    out = x + y
4 counted operations a step and element. Two implementations:
  - `alu_chain_torch`: the plain PyTorch version (the same loop on tensors);
  - the CUDA kernel `ops/csrc/alu_probe.cu`, launched by `alu_chain` for
    tensors on a CUDA device.
`alu_chain` takes the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from . import kernels

OPS_PER_STEP = 4     # add, max, add, max: the reference bench's count


def alu_chain_torch(x, nsteps: int):
    """Plain PyTorch version of the probe; x: int32 tensor, any shape."""
    y = x + 1
    for i in range(nsteps):
        x = torch.maximum(x + i, y)
        y = torch.maximum(y + 2, x)
    return x + y


def alu_chain(x, nsteps: int):
    """The probe on x (contiguous int32). On CUDA tensors this launches the
    CUDA kernel (ops/csrc/alu_probe.cu); on CPU tensors it runs
    `alu_chain_torch`."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("alu_chain: x must be a contiguous int32 tensor")
    if x.device.type == "cpu":
        return alu_chain_torch(x, nsteps)
    if x.device.type != "cuda":
        raise ValueError(f"alu_chain: unsupported device {x.device}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = kernels.lib().bt2_alu_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                                     int(nsteps), stream)
    kernels.check(rc, "alu_probe")
    kernels.LAUNCHES["alu_probe"] += 1
    return out
