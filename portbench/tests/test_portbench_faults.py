"""The check catches what it is there to catch.  A run driven past the
look for a card, with the timed path broken underneath, comes out not
correct under each cell's own limits, for each fault the cell can have
(one card: no exchange between chips to leave out); the sound run comes
out correct.  And the control, the reference one precision below the
configuration's in the program's place, stands out from the program."""

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests.tiny import CPU, run, tiny_cell

TRAIN = ["r18-train-openvocab", "r18-train-nyu40", "r50-train-openvocab"]


def _correct(cell, out):
    return harness.result_line(cell, out, False, CPU)["correct"]


def unchanged(make):
    """A step that returns its state unchanged."""
    def build(cell):
        step = make(cell)

        def keep(state, *args, **kwargs):
            saved = [p.detach().clone() for p in state.model.parameters()]
            out = step(state, *args, **kwargs)
            with torch.no_grad():
                for p, s in zip(state.model.parameters(), saved):
                    p.copy_(s)
            return out
        return keep
    return build


def altered_loss(make):
    """A step whose loss is altered where it is produced."""
    def build(cell):
        step = make(cell)

        def alter(*args, **kwargs):
            state, info = step(*args, **kwargs)
            info = dict(info, total_loss=info["total_loss"] * 1.05)
            return state, info
        return alter
    return build


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [None, unchanged,
                                   calibrate.half_batch_step, altered_loss])
def test_train_faults_are_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    if fault is not None:
        monkeypatch.setattr(harness, "program_train_step",
                            fault(harness.program_train_step))
    out = run(cell)
    assert _correct(cell, out) is (fault is None)


def altered_answer(make):
    def build(cell, model, device):
        predict = make(cell, model, device)

        def alter(depth, text, candidates):
            ids = predict(depth, text, candidates).clone()
            live = candidates[candidates >= 0]
            # the first pick moved to another live candidate
            pos = torch.searchsorted(live, ids[..., 0].contiguous())
            ids[..., 0] = live[(pos + 1) % live.numel()]
            return ids
        return alter
    return build


def half_batch_predict(make):
    def build(cell, model, device):
        predict = make(cell, model, device)

        def half(depth, text, candidates):
            # the left-out maps get no answer
            h = depth.shape[0] // 2
            ids = predict(depth[:h], text, candidates)
            return torch.cat([ids, torch.full_like(ids[:depth.shape[0] - h],
                                                   -1)])
        return half
    return build


@pytest.mark.parametrize("fault", [None, altered_answer, half_batch_predict])
def test_predict_faults_are_not_correct(monkeypatch, fault):
    cell = tiny_cell("r18-predict-bulk")
    if fault is not None:
        monkeypatch.setattr(harness, "program_predict",
                            fault(harness.program_predict))
    out = run(cell)
    assert _correct(cell, out) is (fault is None)


@pytest.mark.parametrize("name", TRAIN)
def test_the_train_control_stands_out(name):
    """At a size the CPU holds the program computes in float32: the
    control (float8 where the cell states bfloat16)
    reads at least three times what the program reads on one of the
    numbers the cell compares."""
    seed = 2 ** 32 + 3
    program = run(tiny_cell(name), seed).detail["gaps"]
    gaps = calibrate.control_train(tiny_cell(name, "bfloat16"), seed, CPU)
    limits = tiny_cell(name).params["limits"]
    assert any(gaps[k] > 3 * program[k] for k in limits)


def test_the_predict_control_stands_out():
    seed = 2 ** 32 + 3
    program = run(tiny_cell("r18-predict-bulk"), seed).detail["gaps"]
    gaps = calibrate.control_predict(tiny_cell("r18-predict-bulk",
                                               "bfloat16"), seed, CPU)
    assert all(gaps[k] > 3 * program[k] for k in gaps)
