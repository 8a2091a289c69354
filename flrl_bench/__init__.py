"""The benchmark of ``fl_rl_compression_mpi_tpu_torch``: its harness, its
yardstick (traffic, reference, checks, metric readers) and its cells'
data.  Run a cell with ``python -m flrl_bench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; see ``BENCHMARK.json`` and ``PERF.md``."""
