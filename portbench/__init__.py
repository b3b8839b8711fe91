"""The benchmark of the PyTorch and CUDA port (``na_dd_tpu_torch``): one
cell of ``BENCHMARK.json`` a run, ``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``.  Configurations, traffic
mixes, drivers and per-layer metric readers are files of their own, found
by the names ``BENCHMARK.json`` gives."""
