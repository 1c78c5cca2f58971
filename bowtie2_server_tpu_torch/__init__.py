"""bowtie2_server_tpu_torch — the PyTorch/CUDA port of bowtie2_server_tpu.

The port runs the unpaired end-to-end/local fast path of the aligner on an
NVIDIA H100 (sm_90a): the fused candidate pipeline is torch tensor code,
and the two dynamic programs the reference package wrote as TPU kernels
are hand-written CUDA C++ (ops/csrc/). On CPU tensors the same functions
run their plain torch versions, which the tests hold bit-exact against the
JAX package (bowtie2_server_tpu), the reference the port is checked
against. The port imports neither jax nor bowtie2_server_tpu.

Package layout (mirrors bowtie2_server_tpu):
  index/    FM-index build + load, k-mer seed tables     (host + torch)
  ops/      banded and rectangle DP: plain torch + CUDA kernels
  align/    the fused candidate pipeline and UnpairedAligner
  io/       FASTQ input, SAM output, run summary
  native/   C++ helpers (suffix array, SAM formatting) via ctypes
  utils/    scoring, presets, simple-func, per-read RNG
"""

__version__ = "0.1.0"
