"""The benchmark of bowtie2_server_tpu_torch: reads served over BT2SRV from
a CUDA card (run.py), the load that sends them (client_proc.py), and the
plain reference that judges the answers (reference.py). BENCHMARK.json at
the repository's root names its cells and metrics."""
