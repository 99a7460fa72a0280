"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by adding files and manifest entries only: in a copy of
the benchmark, the new cell is found and run, and the new metric read,
with no code edited."""

import json
import shutil
import subprocess
import sys

from portbench import harness

DRIVE = """
import json, sys, time
sys.path[:0] = [{copy!r}, {repo!r}]
import torch
import portbench.harness as h
assert h.ROOT == __import__("pathlib").Path({copy!r}) / "portbench"
cell = h.load_cell("tiny-train")
out = h.run_cell(cell, 2 ** 33 + 1, 0.3, False, torch.device("cpu"),
                 time.perf_counter())
cpu = torch.device("cpu")
print(json.dumps([h.result_line(cell, out, False, cpu),
                  h.result_line(cell, out, True, cpu)]))
"""


def test_a_cell_added_as_files_runs_unedited(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(harness.ROOT, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(harness.MANIFEST.read_text())
    bench = copy / "portbench"
    cfg = json.loads((bench / "configs" / "depthclip-r18.json").read_text())
    cfg.update(encoder_filters=[8, 8, 8, 8, 16], embedding_dim=32,
               num_classes=64, resolution=[32, 32], compute_dtype="float32")
    (bench / "configs" / "tiny-r18.json").write_text(json.dumps(cfg))
    mix = {"regions": [2, 4], "floor_frac": 0.55, "vocabulary": 20,
           "zipf": 0.5, "depth_range": [500.0, 3000.0]}
    (bench / "traffic" / "few.json").write_text(json.dumps(mix))
    cell = json.loads((bench / "workloads" / "r18-train-openvocab.json")
                      .read_text())
    cell.update(microbatch=4, trace_steps=2)
    (bench / "workloads" / "tiny-train.json").write_text(json.dumps(cell))
    (bench / "metrics" / "steps_per_call.train.py").write_text(
        "def read(run):\n    return float(len(run.dispatch_s))\n")
    manifest["configs"].append({
        "name": "tiny-r18", "source": "https://example.org/tiny",
        "file": "portbench/configs/tiny-r18.json", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({
        "name": "tiny-train", "config": "tiny-r18", "traffic": "few",
        "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "r18-train-openvocab" in m.get("workloads", []):
            m["workloads"].append("tiny-train")
    manifest["per_layer"].append({
        "name": "steps_per_call.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "train step, host",
        "moves": "train_maps_per_s", "workloads": ["tiny-train"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    done = subprocess.run(
        [sys.executable, "-c", DRIVE.format(copy=str(copy),
                                            repo=str(harness.REPO))],
        capture_output=True, text=True, timeout=600, cwd=copy)
    assert done.returncode == 0, done.stderr[-3000:]
    plain, traced = json.loads(done.stdout.strip().splitlines()[-1])
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"train_maps_per_s",
                                     "train_step_p95_ms", "setup_s"}
    assert traced["metrics"]["steps_per_call.train"]["value"] > 0
    assert "mfu.train" in traced["metrics"]
