// Int32 ALU-ceiling probe: a dependent max/add chain, 4 counted operations
// a step.
//
// Replaces the TPU kernel scripts/bench_dp.py::_measure_alu_ceiling.kern,
// the probe behind the DP microbench's roofline share. It computes the same
// function as that kernel and as the plain torch version alu_chain_torch
// (bowtie2_server_tpu_torch/ops/alu_probe.py), element by element:
//     y = x + 1
//     for i in 0..nsteps-1:  x = max(x + i, y);  y = max(y + 2, x)
//     out = x + y
// The values stay far inside int32 at the probe's 3000 steps (x grows by at
// most i a step: under 4.5e6).
//
// What bounds it on this card: integer issue rate alone. Each thread reads
// and writes CH elements once; between, 4 * nsteps * CH operations.
//
// What the design does about it: each thread carries CH = 8 independent
// (x, y) chains in registers (the role of the TPU kernel's 8 vregs), so
// the two-deep dependency of a step is hidden by instruction-level
// parallelism; the chains of a thread sit a grid-stride apart, so loads and
// stores are coalesced; the launch covers the whole tile in one wave
// (2M elements: 1024 blocks of 256 threads on 132 SMs). The output is
// written, so nothing is dead code. nvcc may fuse an add and a max into one
// DPX instruction (VIADDMNMX) on sm_90a; the probe still counts 4
// operations a step, the definition the JAX bench uses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 8;

__global__ void __launch_bounds__(256)
alu_kernel(const int32_t* __restrict__ x_in, int32_t* __restrict__ out,
           int n, int nsteps) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  int x[CH], y[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int idx = tid + j * nth;
    x[j] = idx < n ? x_in[idx] : 0;
    y[j] = x[j] + 1;
  }
  for (int i = 0; i < nsteps; ++i) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      x[j] = max(x[j] + i, y[j]);
      y[j] = max(y[j] + 2, x[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int idx = tid + j * nth;
    if (idx < n) out[idx] = x[j] + y[j];
  }
}

}  // namespace

// x, out: n int32 (contiguous, on the device). Returns cudaGetLastError()
// after the launch.
extern "C" int bt2_alu_probe(const int32_t* x, int32_t* out, int n,
                             int nsteps, void* stream) {
  if (n <= 0) return 0;
  const int threads = (n + CH - 1) / CH;
  const dim3 block(256);
  const dim3 grid((threads + 255) / 256);
  alu_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, nsteps);
  return static_cast<int>(cudaGetLastError());
}
