"""The benchmark of the PyTorch and CUDA port (visrag_tpu_torch).

One command runs one cell once (`python portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`); BENCHMARK.json at the repo root
names the cells, and every configuration, traffic mix, traffic kind,
per-layer metric and set of limits sits in a file of its own here, found by
the name that BENCHMARK.json gives it.
"""
