"""The scene generator: one seed makes the same scenes; each traffic mix
keeps its labels and its contrast-set size in the range its cells need."""

import pytest
import torch

from portbench import harness, scenes
from portbench.reference import loss as ref_loss

CPU = torch.device("cpu")


def _scenes(mix_name, seed, n=32, shape=(64, 64)):
    mix = harness.read_json(harness.ROOT / "traffic" / f"{mix_name}.json")
    g = torch.Generator().manual_seed(seed)
    vocab = scenes.Vocabulary(mix, 512, g, CPU)
    return mix, scenes.make_scenes(vocab, n, shape, g)


@pytest.mark.parametrize("mix", ["openvocab", "nyu40"])
def test_one_seed_makes_the_same_scenes(mix):
    _, a = _scenes(mix, 123)
    _, b = _scenes(mix, 123)
    _, c = _scenes(mix, 124)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["segmentation"], c["segmentation"])


def test_the_bulk_mix_makes_the_nyu40_scenes():
    """The predict cell's mix is a file of its own, with nyu40's
    parameters: the same scenes from one seed."""
    _, a = _scenes("nyu40", 123)
    _, b = _scenes("nyu40-bulk", 123)
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("mix", ["openvocab", "nyu40"])
def test_scenes_keep_their_shapes_and_labels(mix):
    spec, s = _scenes(mix, 7)
    seg = s["segmentation"]
    assert s["depth"].shape == (32, 64, 64, 1)
    assert seg.min() >= 1 and seg.max() <= spec["vocabulary"]
    # the floor plane: the bottom rows hold one label
    assert (seg[:, -1] == seg[0, -1, 0]).all()
    present = seg[torch.arange(32), :, :].reshape(32, -1)
    obj = s["object_label"]
    assert all((present[i] == obj[i]).any() for i in range(32))
    med = s["depth"].reshape(32, -1).median(dim=1).values
    assert torch.allclose(med, torch.ones(32), atol=1e-2)


@pytest.mark.parametrize("mix", ["openvocab", "nyu40"])
def test_every_seed_holds_as_many_labels(mix):
    """The seed deals out one fixed draw of label ranks: each pool batch
    holds the same number of distinct labels whatever the seed, so every
    seed makes the same contrast-set work."""
    spec = harness.read_json(harness.ROOT / "traffic" / f"{mix}.json")
    for index in (0, 1):
        counts = set()
        for seed in (11, 12, 13):
            g = torch.Generator().manual_seed(seed)
            vocab = scenes.Vocabulary(spec, 512, g, CPU)
            s = scenes.make_scenes(vocab, 64, (64, 64), g, index)
            counts.add(s["segmentation"].unique().numel())
        assert len(counts) == 1


def test_region_counts_are_the_same_work_for_every_seed():
    a = scenes.region_counts(128, 8, 16, torch.Generator().manual_seed(1),
                             CPU)
    b = scenes.region_counts(128, 8, 16, torch.Generator().manual_seed(2),
                             CPU)
    assert sorted(a.tolist()) == sorted(b.tolist())
    assert not torch.equal(a, b)


@pytest.mark.parametrize("seed", [3, 4])
def test_openvocab_overflows_the_packed_capacity(seed):
    """A batch of 128 open-vocabulary scenes holds far more labels than
    the 128-member packed CE can take: the member-only route runs."""
    _, s = _scenes("openvocab", seed, n=128)
    distinct = s["segmentation"].unique().numel()
    assert 200 <= distinct <= 400
    g = torch.Generator().manual_seed(seed)
    draws = scenes.pixel_draws(128, (64, 64), 0.7, g, CPU)
    weights = ref_loss.pixel_weights(s["segmentation"], draws)
    medium = scenes.similarity_sets(512, 3, g, CPU)
    mask = ref_loss.contrast_mask(
        s["segmentation"], weights, 512, medium, medium, 50, 0.25, 0.5,
        (scenes.gumbel(512, g, CPU), scenes.gumbel(512, g, CPU)))
    assert int(mask.sum()) > 128


@pytest.mark.parametrize("seed", [3, 4])
def test_nyu40_stays_within_the_packed_capacity(seed):
    _, s = _scenes("nyu40", seed, n=128)
    assert s["segmentation"].unique().numel() + 50 <= 128


def test_similarity_sets_hold_other_classes():
    m = scenes.similarity_sets(64, 3, torch.Generator().manual_seed(0), CPU)
    assert (m.sum(dim=1) == 3).all()
    assert not m.diagonal().any()
