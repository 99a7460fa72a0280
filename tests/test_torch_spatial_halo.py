"""The UNet's layers over a grid's 'spatial' axis (``parallel/halo.py``),
held against the whole map in f64.

Two and four gloo ranks on the CPU (``tests/torch_dist_worker.py``, mode
``halo``) each run every case of ``halo_cases`` on their rows: the
convolutions (k 1/3/7, stride 1/2, dilation 1/6/18), the max and average
pools, the transposed convolutions, GroupNorm's and InstanceNorm's
statistics, the means, the decoder's bilinear resize, the nearest resize
and ``UpConv2d``, the model's ASPP, and the block library's ASPP and SPP
(eval mode on BatchNorm's running statistics, train mode on the batch's,
synced over the spatial ranks, and with InstanceNorm), at heights that
leave a rank's block empty and halos wider than a block.  Each rank's
output rows and input-gradient rows must match the whole map's, and the
parameter gradients summed over the ranks the whole map's, to 1e-12.
Some cases compute in f32 inside, as the model does: the resize
(``ops/resize``; its output bit-equal, its gradients to 1e-6), the
library's ASPP and SPP (their f32 resizes; to 1e-6) and the model's ASPP
(its GroupNorm; to 1e-5).  The library ASPP's pooled branch runs on every
spatial rank's copy of the pooled map: in train mode its synced
BatchNorm and its gradient must still count each image once.
The grid's train step refuses, on every rank together, spatial blocks of
unequal or odd row counts.  In one process: the row plans, the height rule
of ``Grid.local_batch``, and that nothing changes outside the context."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.ops import blocks
from rangeclip_tpu_torch.parallel.halo import (
    input_rows,
    remote_rows,
    sharded_rows,
    transposed_input_rows,
)
from rangeclip_tpu_torch.parallel.mesh import (
    Grid,
    all_reduce_exact,
    make_grid,
    owned_rows,
)
from torch_dist_worker import halo_cases, join_ranks, start_ranks

CASES = halo_cases()
LAYERS = sorted({name.split(" h")[0] for name, *_ in CASES})


def _whole(make):
    f, x, g, module = make()
    x.requires_grad_(True)
    y = f(x)
    (y * g).sum().backward()
    dp = {} if module is None else {n: p.grad for n, p in
                                    module.named_parameters()
                                    if p.grad is not None}
    return y.detach(), x.grad, dp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: every rank's results} for 2 and 4 ranks, started together,
    and the whole map's results, computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("halo")
    started = {}
    for world in (2, 4):
        root = tmp / f"w{world}"
        root.mkdir()
        started[world] = start_ranks("halo", world, root, root / "none",
                                     threads=1)
    whole = {name: _whole(make) for name, _, _, make in CASES}
    got = {world: [torch.load(p) for p in join_ranks(*procs)]
           for world, procs in started.items()}
    return got, whole


def _close(a, b, tol, what):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("world", [2, 4])
def test_halo_layer_matches_the_whole_map_f64(ranks, world, layer):
    got, whole = ranks
    for name, height, _, _ in CASES:
        if name.split(" h")[0] != layer:
            continue
        y, dx, dp = whole[name]
        resize = name.startswith("resize")
        # the library's pyramids resize in f32 inside, as the resize does
        tol = (1e-6 if resize or name.startswith(("library aspp", "spp"))
               else 1e-5 if name.startswith("aspp") else 1e-12)
        for r, res in enumerate(got[world]):
            mine = res[name]
            if y.dim() == 4:
                lo, hi = owned_rows(y.shape[2], world, r)
                want = y[:, :, lo:hi]
            else:
                want = y
            if resize:
                assert torch.equal(mine["y"], want), name
            else:
                _close(mine["y"], want, tol, f"{name} rank {r} output")
            lo, hi = owned_rows(height, world, r)
            _close(mine["dx"], dx[:, :, lo:hi], tol,
                   f"{name} rank {r} input gradient")
        for p, want in dp.items():
            total = sum(res[name]["dp"][p] for res in got[world])
            _close(total, want, tol, f"{name} {p} gradient")


@pytest.mark.parametrize("world", [2, 4])
def test_grid_step_refuses_blocks_off_the_height_rule(ranks, world):
    """A 30-row batch cut by ``owned_rows`` alone: 15 rows a rank on two
    (odd), 8, 8, 8 and 6 on four (unequal, all even).  Every rank's train
    step refuses it, together, instead of planning its halos for another
    global height than its neighbours'."""
    for res in ranks[0][world]:
        assert res["step refusal"] is not None
        assert "must divide by 2 x the 'spatial' size" in \
            res["step refusal"], res["step refusal"]


def test_local_batch_refuses_a_height_off_the_grid():
    """``Grid.local_batch`` holds the global height to 2 x the 'spatial'
    size, where the whole batch is known: 30 rows over four ranks would
    cut blocks of 8, 8, 8 and 6."""
    grid = Grid(1, 4, 1, 0, 0, 0, {"data": None, "spatial": None,
                                   "model": None, "batch": None})
    with pytest.raises(ValueError, match="height 30 must divide by 2x the "
                                         "'spatial' size 4"):
        grid.local_batch({"depth": torch.zeros(1, 30, 8, 1)})
    assert grid.local_batch({"depth": torch.zeros(1, 32, 8, 1),
                             "label": torch.zeros(1, 3)})["depth"].shape \
        == (1, 8, 8, 1)


def test_row_plans():
    """GSPMD's ceil(h / n) tiles, empty at the end; a strided window from
    global rows; a transposed convolution's reach; the rows that travel
    (none where every window is at home, all of them for a dilation wider
    than the map)."""
    assert [owned_rows(5, 4, r) for r in range(4)] == [(0, 2), (2, 4),
                                                       (4, 5), (5, 5)]
    assert [owned_rows(1, 4, r) for r in range(4)] == [(0, 1), (1, 1),
                                                       (1, 1), (1, 1)]
    # output rows 3..5 of a 3x3 stride-2 conv (pad 1) read rows 5..10
    assert input_rows(3, 5, 3, 2, 1) == (5, 10)
    assert input_rows(3, 3, 3, 2, 1) == (5, 5)
    assert input_rows(0, 2, 7, 2, 3) == (-3, 6)
    assert input_rows(0, 4, 3, 1, 18, 18) == (-18, 22)
    # k2 s2: output rows 2i, 2i + 1 from input row i
    assert transposed_input_rows(3, 6, 2, 2, 0, 4) == (1, 3)
    assert transposed_input_rows(0, 2, 3, 2, 1, 4) == (0, 2)
    h, n = 8, 4
    windows = [input_rows(*owned_rows(h, n, r), 1) for r in range(n)]
    assert remote_rows(h, n, windows) == []  # a 1x1 stride-1 conv
    windows = [input_rows(*owned_rows(h, n, r), 3, 1, 18, 18)
               for r in range(n)]
    assert remote_rows(h, n, windows) == list(range(h))


def test_outside_the_context_nothing_changes():
    """Outside ``sharded_rows`` (and inside it with one spatial rank) the
    routed layers are their plain calls, bit for bit; a process grid in one
    process is the one cell; the exact all-reduce of one rank is the
    tensor itself."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(3, 4, 3, 2, 1, bias=False)
    x = torch.randn(2, 3, 9, 7)
    grid = make_grid()
    assert grid.shape == {"data": 1, "spatial": 1, "model": 1}
    assert grid.groups == {"data": None, "spatial": None, "model": None,
                           "batch": None}
    with sharded_rows(grid, (9, 7)) as shards:
        assert shards is None and blocks._SPATIAL is None
        y = blocks.conv2d(conv, x)
    assert torch.equal(y, F.conv2d(x, conv.weight, None, 2, 1))
    assert torch.equal(blocks.max_pool2d(x, 3, 2, 1),
                       F.max_pool2d(x, 3, 2, 1))
    assert torch.equal(blocks.spatial_mean(x), x.mean(dim=(2, 3)))
    assert blocks.map_size(x) == (9, 7)
    assert all_reduce_exact(x, None) is x
