"""Cells cut to a size the CPU runs in seconds, for the tests: the same
files and code paths as the benchmark's cells, with narrow widths, small
maps and the program in float32 (its plain versions run on the CPU)."""

from __future__ import annotations

import copy

import torch

from portbench import harness

CPU = torch.device("cpu")


def tiny_cell(name: str, compute_dtype: str = "float32") -> harness.Cell:
    cell = harness.load_cell(name)
    cfg = dict(cell.config)
    cfg.update(encoder_filters=[8, 8, 8, 8, 16], embedding_dim=32,
               num_classes=64, resolution=[32, 32],
               compute_dtype=compute_dtype)
    cell.config = cfg
    p = copy.deepcopy(cell.params)
    if cell.kind == "train":
        p.update(microbatch=4, trace_steps=2)
    else:
        p.update(batch=4, slots=128, negatives=20, calibration_maps=2,
                 check={"among": 4, "calls": 2, "maps": 4, "pixels": 16})
    cell.params = p
    mix = dict(cell.mix)
    mix["vocabulary"] = min(mix["vocabulary"], 63)
    cell.mix = mix
    return cell


def run(cell: harness.Cell, seed: int = 2 ** 31 + 11, seconds: float = 0.3):
    import time

    return harness.run_cell(cell, seed, seconds, False, CPU,
                            time.perf_counter())
