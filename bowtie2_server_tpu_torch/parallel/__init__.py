"""Read-sharded data parallelism over a 'dp' mesh of torch devices (port
of bowtie2_server_tpu/parallel/)."""
