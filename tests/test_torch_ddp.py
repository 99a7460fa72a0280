"""The port's ``ddp_parity`` step over two gloo ranks on the CPU, against
JAX's ``make_train_step(ddp_parity=True)`` on a two-device mesh: the same
weights (carried by the JAX package's reference-checkpoint converter), the
same batch, each rank's draws rebuilt from JAX's keys (``fold_in(fold_in(key,
i), rank)``, then the loss's splits), SGD as JAX's own DDP test takes it.
Held to that test's tolerances (``tests/test_parallel.py:300-307``); the
two ranks end bit-equal.  The step without ``ddp_parity``, the global-batch
step, is ``test_torch_global_batch.py``'s.  Also: the train loader's shards
equal the JAX loader's, and the multi-rank dry run on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rangeclip_tpu.data.dataset import ImageDepthTextDataset as JaxDataset
from rangeclip_tpu.data.loader import ShardedBatchLoader as JaxLoader
from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.torch_interop import convert_reference_checkpoint
from rangeclip_tpu.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
    shard_state,
)
from rangeclip_tpu.training.state import TrainState as JaxTrainState
from rangeclip_tpu.training.train_step import make_train_step as jax_step
from rangeclip_tpu_torch.data import synthetic
from rangeclip_tpu_torch.data.dataset import ImageDepthTextDataset
from rangeclip_tpu_torch.data.loader import (
    ShardedBatchLoader,
    deterministic_split,
)
from rangeclip_tpu_torch.losses.infonce import n_draws
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.models.interop import state_dict_from_jax
from rangeclip_tpu_torch.parallel.dryrun import dryrun_multichip
from torch_dist_worker import join_ranks, start_ranks

FILTERS = (8, 16, 16, 16, 32)
A, B, H, C, D = 2, 8, 32, 24, 32  # B rows over 2 ranks
RANKS = 2
LR = 1e-3


def _draws(key, rank):
    """Rank ``rank``'s draws per microbatch, as JAX's ddp_parity step keys
    them (train_step.py:200): fold_in(fold_in(key, i), rank)."""
    out = {}
    for i in range(A):
        rank_key = jax.random.fold_in(jax.random.fold_in(key, i), rank)
        key_pix, key_contrast = jax.random.split(rank_key)
        out[f"pixels.{rank}.{i}"] = np.array(jax.random.randint(
            key_pix, (B // RANKS, n_draws(H, H)), 0, H * H), np.int32)
        for j, k in enumerate(jax.random.split(key_contrast)):
            out[f"gumbel{j}.{rank}.{i}"] = np.array(
                jax.random.gumbel(k, (C,)), np.float32)
    return out


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """(rank outputs, JAX state, JAX info, the port's init state dict)."""
    tmp = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 12, (A, B, H, H)).astype(np.int32)
    batch = {
        "depth": rng.standard_normal((A, B, H, H, 1)).astype(np.float32),
        "segmentation": seg,
        "object_label": seg[:, :, 5, 5].copy(),
        "image_embeddings": rng.standard_normal((A, B, D)).astype(np.float32),
        "sample_valid": np.array([[1] * 8, [1, 0, 1, 1, 1, 1, 0, 1]],
                                 np.float32),
    }
    text = rng.standard_normal((C, D)).astype(np.float32)
    medium = rng.random((C, C)) < 0.15
    hard = rng.random((C, C)) < 0.15
    port = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                     embedding_dim=D),
                     generator=torch.Generator().manual_seed(5))
    init = {k: v.clone() for k, v in port.state_dict().items()}
    params, stats = convert_reference_checkpoint(
        *({k: v.detach().numpy() for k, v in m.state_dict().items()}
          for m in (port.encoder, port.decoder)),
        port.log_temperature_text.detach().numpy(),
        port.log_temperature_image.detach().numpy())

    key = jax.random.key(7)
    inputs = {**batch, "text": text, "medium": medium, "hard": hard,
              "lr": np.float32(LR), "filters": np.array(FILTERS),
              "dim": np.int32(D),
              **{f"sd.{k}": v.numpy() for k, v in init.items()}}
    for r in range(RANKS):
        inputs.update(_draws(key, r))
    np.savez(tmp / "inputs.npz", **inputs)
    procs, outs = start_ranks("ddp", RANKS, tmp, tmp / "inputs.npz")

    # JAX's ddp_parity step, compiled once, while the ranks run
    opt = optax.sgd(1.0)
    model = JaxDepthUNet(JaxConfig(encoder_filters=FILTERS, embedding_dim=D,
                                   use_batch_norm=True))
    mesh = make_mesh(n_data=RANKS, n_model=1)
    step = jax_step(model, opt, JaxLossConfig(), accum_steps=A,
                    ddp_parity=True, mesh=mesh, donate=False)
    jstate = JaxTrainState(step=jnp.int32(0), params=params,
                           batch_stats=stats, opt_state=opt.init(params))
    with jax.sharding.set_mesh(mesh):
        jstate, jinfo = step(
            shard_state(mesh, jstate), shard_batch(mesh, batch, batch_axis=1),
            key, jnp.float32(LR), jnp.float32(0.25), jnp.float32(0.5),
            replicate(mesh, jnp.asarray(text)),
            replicate(mesh, jnp.asarray(medium)),
            replicate(mesh, jnp.asarray(hard)))
    ranks = [torch.load(p) for p in join_ranks(procs, outs)]
    return ranks, jax.device_get(jstate), jax.device_get(jinfo), init


def test_ddp_parity_two_ranks_match_jax(ddp_run):
    """Loss within rtol 2e-5, parameters within rtol 5e-4 / atol 5e-6,
    BatchNorm running statistics within rtol 5e-4 / atol 5e-7 of JAX's
    ddp_parity step, 4 rows a rank; most parameters with a gradient moved
    (lr * g can be under half an ulp of a weight)."""
    ranks, jstate, jinfo, init = ddp_run
    got = ranks[0]
    np.testing.assert_allclose(got["info"]["total_loss"],
                               float(jinfo["total_loss"]), rtol=2e-5)
    want = state_dict_from_jax(jstate.params, jstate.batch_stats)
    checked = moved = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got["state"][name]) == A
            continue
        if "running_" in name:
            np.testing.assert_allclose(got["state"][name].numpy(), w.numpy(),
                                       rtol=5e-4, atol=5e-7, err_msg=name)
            continue
        if name not in got["grads"]:
            continue  # an identity block's projection: absent in JAX
        np.testing.assert_allclose(got["state"][name].numpy(), w.numpy(),
                                   rtol=5e-4, atol=5e-6, err_msg=name)
        moved += not torch.equal(got["state"][name], init[name])
        checked += 1
    assert checked > 50 and moved > checked // 2, (moved, checked)


def test_ddp_parity_ranks_end_bit_equal(ddp_run):
    """Both ranks hold the same parameters, BatchNorm statistics,
    gradients and info after the step."""
    ranks = ddp_run[0]
    for part in ("state", "grads"):
        assert sorted(ranks[0][part]) == sorted(ranks[1][part])
        for name, t in ranks[0][part].items():
            assert torch.equal(t, ranks[1][part][name]), (part, name)
    assert ranks[0]["info"] == ranks[1]["info"]


def test_train_loader_shards_match_jax(tmp_path, monkeypatch):
    """shard_id / num_shards: each of 4 shards of the 9 train indices
    yields the JAX loader's batches for that shard (DistributedSampler
    order, padded to 12 by wrapping), and every shard has 3."""
    monkeypatch.setenv("RANGECLIP_NATIVE", "off")
    paths = synthetic.write_synthetic_dataset(str(tmp_path), n_samples=16,
                                              shape=(24, 20), num_classes=8)
    train_idx, _, _ = deterministic_split(16)
    size = (24, 20)
    lengths = set()
    for shard in range(4):
        ours = ShardedBatchLoader(
            ImageDepthTextDataset(paths["metadata"], paths["labels"], size),
            train_idx, 1, shuffle=True, drop_last=True, num_workers=2,
            shard_id=shard, num_shards=4)
        theirs = JaxLoader(JaxDataset(paths["metadata"], paths["labels"],
                                      size),
                           train_idx, 1, shard, 4, shuffle=True,
                           drop_last=True, num_workers=1)
        ours.set_epoch(2)
        theirs.set_epoch(2)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        lengths.add(len(ours))
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert lengths == {3}


def test_dryrun_multichip_on_the_cpu(monkeypatch):
    """dryrun_multichip(2) on the CPU: two gloo ranks of the ddp_parity step
    against the in-process simulation (bit-equal here: two summands), the
    global-batch step against the single-device step, and a 2 x 1 predict
    grid against single-device predict.  The ranks and this process run 2
    threads each, so that their CPU kernels sum in the same order."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the spawned ranks'
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        summary = dryrun_multichip(2, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert summary["ranks"] == 2 and summary["backend"] == "gloo"
    assert summary["errors"]["grads"] == 0.0
    assert summary["errors"]["params_close"] == 1.0
    assert summary["predict"]["grid"] == [2, 1]
    assert np.isfinite(summary["loss"])
