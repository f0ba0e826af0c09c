"""The benchmark of the PyTorch/CUDA port (``image_search_tpu_torch``).

Run one cell with ``python3 bench_port/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the repository root
names the cells, and each configuration, traffic mix and per-layer metric
is a file of its own here, found by its name.
"""
