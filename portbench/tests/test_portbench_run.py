"""run.py's refusals: no card, or a checkout that holds only the
benchmark; both exit with a code other than 0 and print no result."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

ARGS = ["--workload", "r18-train-openvocab", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          capture_output=True, text=True, timeout=300,
                          cwd=cwd)


def _no_result(done):
    for line in done.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_without_a_card_it_fails_clearly(no_card):
    done = _run(harness.REPO)
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr
    _no_result(done)


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _run(tmp_path)
    assert done.returncode != 0
    _no_result(done)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    done = _run(harness.REPO)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
