"""The plain reference against the program's plain CPU path at small
widths, through the harness's own set-up and check: the program's first
three steps (loss, first gradient, parameters' change) and its predict
agree with the reference to float32 rounding."""

import pytest
import torch

from portbench import harness
from portbench.reference import model as ref_model
from portbench.tests.tiny import CPU, run, tiny_cell


# ResNet-50's block layout, which the reference also writes out
R50 = {"n_layer": 50, "block": "bottleneck", "n_blocks": [3, 4, 6, 3],
       "expansion": 4}
# the instance-norm DepthUNet (no norm parameters or statistics)
INORM = {"norm": "instance"}


def with_layout(cell, layout):
    cell.config = dict(cell.config, **layout)
    return cell


@pytest.mark.parametrize("layout", [{}, R50, INORM])
@pytest.mark.parametrize("mix", ["openvocab", "nyu40"])
def test_train_steps_agree_with_the_reference(layout, mix):
    cell = with_layout(tiny_cell("r18-train-openvocab"), layout)
    cell.mix = dict(harness.read_json(harness.ROOT / "traffic"
                                      / f"{mix}.json"), vocabulary=39)
    out = run(cell)
    values = out.detail["gaps"]
    assert values["loss_gap"] < 1e-5
    assert values["grad_gap"] < 1e-4
    assert values["grad_gap_median"] < 1e-5
    assert values["change_gap"] < 1e-2
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("layout", [{}, INORM])
def test_predict_agrees_with_the_reference(layout):
    out = run(with_layout(tiny_cell("r18-predict-bulk"), layout))
    assert max(out.detail["gaps"].values()) < 1e-5


@pytest.mark.parametrize("bad", [{"n_filters": [8, 16]},
                                 {"aspp_rates": [1, 6, 12]},
                                 {"aspp_groups": 16},
                                 {"n_blocks": [3, 4, 6, 3]},
                                 {"norm": "group"}])
def test_a_configuration_the_program_does_not_build_is_refused(bad):
    cell = tiny_cell("r18-train-openvocab")
    cell.config = dict(cell.config, **bad)
    with pytest.raises((ValueError, RuntimeError)):
        harness.port_model(cell.config, ref_model.make_params(
            cell.config, harness.generator(5, harness.WEIGHTS, CPU), CPU),
            CPU)


@pytest.mark.parametrize("layout", [{}, R50, INORM])
def test_the_weights_fill_the_programs_state_dict(layout):
    from rangeclip_tpu_torch.models.depth_unet import DepthUNet

    cfg = dict(harness.read_json(harness.ROOT / "configs"
                                 / "depthclip-r18.json"), **layout)
    spec = {name: shape for name, shape, _, _ in ref_model.param_spec(cfg)}
    model = DepthUNet(harness.port_config(cfg),
                      device=torch.device("meta"))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == {k: tuple(s) for k, s in spec.items()}


def test_weights_are_the_same_for_one_seed():
    cfg = tiny_cell("r18-train-openvocab").config
    a = ref_model.make_params(cfg, harness.generator(9, harness.WEIGHTS,
                                                     CPU), CPU)
    b = ref_model.make_params(cfg, harness.generator(9, harness.WEIGHTS,
                                                     CPU), CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
