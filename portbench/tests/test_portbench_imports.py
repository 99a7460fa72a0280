"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; both checked in fresh processes,
by whole top-level module names."""

import json
import subprocess
import sys

from portbench import harness

REPO = str(harness.REPO)

RUN_TINY = """
import json, sys
sys.path.insert(0, {repo!r})
from portbench.tests.tiny import tiny_cell, run
from portbench import harness
for name in ("r18-train-openvocab", "r18-predict-bulk"):
    run(tiny_cell(name))
print(json.dumps(sorted(set(m.split(".")[0] for m in sys.modules))))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
import portbench.reference.model, portbench.reference.loss
import portbench.reference.predict
print(json.dumps(sorted(set(m.split(".")[0] for m in sys.modules))))
"""


def _top_level(code):
    done = subprocess.run([sys.executable, "-c", code.format(repo=REPO)],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert done.returncode == 0, done.stderr[-2000:]
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(RUN_TINY)
    assert "rangeclip_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rangeclip_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "rangeclip_tpu",
                        "rangeclip_tpu_torch"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rangeclip_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]
