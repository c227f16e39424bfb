"""Tiny versions of the benchmark's cells for the CPU tests: the cells of
BENCHMARK.json with their configurations cut to `SIZE` and short windows.
The program runs its plain versions on CPU tensors; no number of such a
run is a device number."""

from __future__ import annotations

import time

from portbench import run, spec

SIZE = (24, 16)


def tiny(workload: str, warmup: int = 6):
    bench = spec.load_benchmark()
    cell = spec.cell(bench, workload)
    cfg = spec.config(bench, cell["config"])
    cfg["width"], cfg["height"] = SIZE
    mix = spec.traffic(cell["traffic"])
    mix["warmup_frames"] = warmup
    return bench, cell, cfg, mix


def rehearse(workload: str, seconds: float = 2.0, trace: bool = False, seed: int = 2 ** 31 + 7):
    """One run of a tiny cell on the CPU: run.run_cell's result line."""
    bench, cell, cfg, mix = tiny(workload)
    return run.run_cell(bench, cell, cfg, mix, seed, seconds, trace, "cpu",
                        start=time.perf_counter())
