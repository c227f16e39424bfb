"""The benchmark of flexlight_tpu_torch on one CUDA card.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` renders one cell of BENCHMARK.json and prints one JSON
line. Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own (configs/, traffic/, metrics/),
found by the name BENCHMARK.json gives it; README.md says how to add
each. The reference that decides `correct` (reference/) is plain
PyTorch and imports nothing of the program.
"""
