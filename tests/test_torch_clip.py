"""The port's CLIP towers, tokenizer, checkpoint conversion, providers and
the MaskCLIP / SegFormer probes against the JAX package (and HF
``transformers`` where it imports) on the CPU, at a tiny config with inputs
from numpy seeds; the JAX towers' params are carried across with
``clip_state_dict_from_jax``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.evals import baselines as jax_baselines
from rangeclip_tpu.models.clip import provider as jax_provider
from rangeclip_tpu.models.clip.model import CLIPConfig as JaxCLIPConfig
from rangeclip_tpu.models.clip.model import CLIPTextTower as JaxText
from rangeclip_tpu.models.clip.model import CLIPVisionTower as JaxVision
from rangeclip_tpu.models.clip.tokenizer import CLIPTokenizer as JaxTokenizer
from rangeclip_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from rangeclip_tpu.utils.math import l2_normalize as jax_l2_normalize
from rangeclip_tpu_torch.evals import baselines
from rangeclip_tpu_torch.models.clip import provider
from rangeclip_tpu_torch.models.clip.crops import clip_normalize
from rangeclip_tpu_torch.models.clip.convert import (
    convert_clip_checkpoint,
    hf_state_dict,
    read_safetensors,
    write_safetensors,
)
from rangeclip_tpu_torch.models.clip.model import (
    CLIP_VIT_B32,
    CLIPConfig,
    CLIPTextTower,
    CLIPVisionTower,
)
from rangeclip_tpu_torch.models.clip.tokenizer import (
    CLIPTokenizer,
    bytes_to_unicode,
)
from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
from rangeclip_tpu_torch.models.interop import clip_state_dict_from_jax

TINY_KW = dict(vocab_size=99, max_position_embeddings=16, text_width=32,
               text_heads=4, text_layers=2, image_size=32, patch_size=8,
               vision_width=48, vision_heads=4, vision_layers=2,
               projection_dim=24)
CFG = CLIPConfig(**TINY_KW)
JAX_CFG = JaxCLIPConfig(**TINY_KW)
CPU = torch.device("cpu")
t = torch.from_numpy


def _ids(seed, n=3, length=12):
    """Token rows framed as CLIP frames them: 97 start, 98 end (the
    vocabulary's highest id in use), zero padding."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, length), np.int32)
    for b in range(n):
        k = rng.integers(3, length - 1)
        ids[b, 0] = 97
        ids[b, 1:k] = rng.integers(1, 90, k - 1)
        ids[b, k] = 98
    return ids


def _pixels(seed, n=2, size=32):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _jax_tower(kind, seed):
    """(JAX module, its params as numpy, the port tower with them)."""
    if kind == "text":
        module, x, cls = JaxText(JAX_CFG), jnp.asarray(_ids(0)), \
            CLIPTextTower
    else:
        module, x, cls = JaxVision(JAX_CFG), jnp.asarray(_pixels(0)), \
            CLIPVisionTower
    params = jax.tree.map(np.asarray, module.init(
        jax.random.key(seed), x)["params"])
    tower = cls(CFG)
    tower.load_state_dict(clip_state_dict_from_jax(params), strict=True)
    return module, params, tower.eval()


@pytest.mark.parametrize("kind", ["text", "vision", "patches"])
def test_towers_match_jax(kind):
    """fp32, params carried across: within 1e-5 relative."""
    module, params, tower = _jax_tower("text" if kind == "text" else
                                       "vision", 1)
    x = _ids(2) if kind == "text" else _pixels(3)
    patches = kind == "patches"
    args = (patches,) if kind != "text" else ()
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x), *args))
    with torch.no_grad():
        got = tower(t(x), *args).numpy()
    assert got.shape == want.shape
    assert want.shape == {"text": (3, 24), "vision": (2, 24),
                          "patches": (2, 4, 4, 24)}[kind]
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _tiny_hf_model(monkeypatch):
    # HF's PyTorch classes only: importing TensorFlow as well takes seconds
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(
        text_config=dict(
            vocab_size=99, max_position_embeddings=16, hidden_size=32,
            num_attention_heads=4, num_hidden_layers=2,
            intermediate_size=128, hidden_act="quick_gelu",
            bos_token_id=97, eos_token_id=98),
        vision_config=dict(
            image_size=32, patch_size=8, hidden_size=48,
            num_attention_heads=4, num_hidden_layers=2,
            intermediate_size=192, hidden_act="quick_gelu"),
        projection_dim=24)
    torch.manual_seed(0)
    return transformers.CLIPModel(cfg).eval()


@pytest.mark.parametrize("suffix", [".safetensors", ".bin"])
def test_converted_towers_match_hf(tmp_path, monkeypatch, suffix):
    """An HF CLIP state dict, saved as ``.safetensors`` (read by the
    port's reader) or ``.bin``, converts to towers that load strictly and
    reproduce HF's get_text_features / get_image_features; the split
    inverts (``hf_state_dict``)."""
    hf = _tiny_hf_model(monkeypatch)
    sd = hf.state_dict()
    path = str(tmp_path / f"clip{suffix}")
    if suffix == ".bin":
        torch.save(sd, path)
    else:
        write_safetensors(path, {k: v.numpy() for k, v in sd.items()})
    text_sd, vision_sd = convert_clip_checkpoint(path)
    text, vision = CLIPTextTower(CFG), CLIPVisionTower(CFG)
    text.load_state_dict(text_sd, strict=True)
    vision.load_state_dict(vision_sd, strict=True)
    ids, pix = _ids(4), _pixels(5)
    with torch.no_grad():
        want_t = hf.get_text_features(
            input_ids=t(ids).long(),
            attention_mask=torch.ones(ids.shape, dtype=torch.long)).numpy()
        want_v = hf.get_image_features(
            pixel_values=t(pix).permute(0, 3, 1, 2)).numpy()
        got_t = text(t(ids)).numpy()
        got_v = vision(t(pix)).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_v, want_v, rtol=2e-4, atol=2e-5)
    back = hf_state_dict(text, vision)
    assert sorted(back) == sorted(k for k in sd if k != "logit_scale")
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def _write_vocab(tmp_path, merges=()):
    """A byte-level vocabulary (every byte symbol alone and as a word end),
    the pairs in ``merges`` merged, then the framing tokens with the end
    token last, as in CLIP's vocabulary."""
    symbols = list(bytes_to_unicode().values())
    vocab = {}
    for s in symbols + [s + "</w>" for s in symbols]:
        vocab[s] = len(vocab)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vp, mp = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    with open(vp, "w") as f:
        json.dump(vocab, f)
    with open(mp, "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return vp, mp, vocab


MERGES = (("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>"),
          ("Ã", "©"), ("1", "2"), ("s", "</w>"))
TEXTS = ("the cat", "Café  table_ it's 42 cats!", "Naïve Über-model no.7",
         "  ﬁsh   &  chips?!  ", "x" * 3 + " the" * 80)


def test_tokenizer_matches_jax(tmp_path):
    """Unicode, digits, punctuation, BPE merges, and a text past 77 tokens
    (truncated, the end token kept): identical ids."""
    vp, mp, vocab = _write_vocab(tmp_path, MERGES)
    ours, theirs = CLIPTokenizer(vp, mp), JaxTokenizer(vp, mp)
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text), text
    got, want = ours(list(TEXTS)), theirs(list(TEXTS))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(TEXTS), 77) and got.dtype == np.int32
    assert got[-1, -1] == vocab["<|endoftext|>"]
    assert ours.encode("the cat") == [vocab["the</w>"], vocab["cat</w>"]]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_safetensors_reader_matches_library(tmp_path, dtype):
    """The port's reader against ``safetensors.numpy.load_file`` on a file
    that ``safetensors.torch`` wrote (bf16 reaches numpy as ml_dtypes'
    bfloat16, which the JAX package's import registers; the port widens
    it exactly to f32), and the port's writer's files read back through
    the library."""
    st_torch = pytest.importorskip("safetensors.torch")
    st_numpy = pytest.importorskip("safetensors.numpy")
    gen = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(5, 7, generator=gen),
               "b": torch.randn(3, generator=gen) * 1e3,
               "c.scalar": torch.tensor(2.5),
               "d.ids": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    tensors = {k: v.to(getattr(torch, dtype)) if v.is_floating_point()
               else v for k, v in tensors.items()}
    path = str(tmp_path / "x.safetensors")
    st_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    want = st_numpy.load_file(path)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k, v in want.items():
        if dtype == "bfloat16" and k != "d.ids":
            assert str(v.dtype) == "bfloat16"
            v = v.astype(np.float32)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(
            got[k], tensors[k].float().numpy() if dtype == "bfloat16"
            and k != "d.ids" else tensors[k].numpy(), err_msg=k)
    if dtype != "bfloat16":
        again = str(tmp_path / "y.safetensors")
        write_safetensors(again, got)
        for k, v in st_numpy.load_file(again).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_random_image_provider_dim_rules():
    """"random" builds the real tower (seeded: two builds agree); ``dim``
    widens only the default config, a custom config keeps its own width
    and a conflicting ``dim`` raises, as in JAX; the tower needs a named
    device."""
    for kwargs in ({"dim": 24}, {"dim": None}, {}):
        embedder = provider.get_image_provider("random", config=CFG,
                                               device=CPU, **kwargs)
        assert isinstance(embedder, provider.CLIPImageEmbedder)
        assert embedder.dim == CFG.projection_dim
    theirs = jax_provider.get_image_provider("random", config=JAX_CFG,
                                             dim=24)
    assert theirs.dim == CFG.projection_dim
    for dim in (7, 48):
        for get, cfg in ((provider.get_image_provider, CFG),
                         (jax_provider.get_image_provider, JAX_CFG)):
            extra = {"device": CPU} if cfg is CFG else {}
            with pytest.raises(ValueError, match="conflicts"):
                get("random", dim=dim, config=cfg, **extra)
    # the default config: widened to dim, as the trainer asks for its
    # embedding dim (meta device: the shapes without ViT-B/32's weights)
    assert CLIP_VIT_B32.projection_dim == 512
    wide = provider.get_image_provider("random", dim=32,
                                       device=torch.device("meta"))
    assert wide.dim == 32 and wide.tower.config.vision_layers == 12
    assert wide.tower.visual_projection.weight.shape == (32, 768)
    crops = t(_pixels(6))
    a = provider.get_image_provider("random", config=CFG, device=CPU)(crops)
    b = provider.get_image_provider("random", config=CFG, device=CPU)(crops)
    assert a.shape == (2, 24) and torch.equal(a, b)
    with pytest.raises(ValueError, match="device"):
        provider.get_image_provider("random", config=CFG)


def test_text_provider_matches_jax(tmp_path):
    """The whole text path from files: an HF-layout checkpoint written as
    ``.safetensors``, the tokenizer's vocab and merges, 130 labels batched
    by 128 (the last chunk padded): the port's table against JAX's."""
    vp, mp, vocab = _write_vocab(tmp_path, MERGES)
    kw = {**TINY_KW, "vocab_size": len(vocab),
          "max_position_embeddings": 77}
    cfg, jax_cfg = CLIPConfig(**kw), JaxCLIPConfig(**kw)
    text = CLIPTextTower(cfg, generator=torch.Generator().manual_seed(1))
    vision = CLIPVisionTower(cfg, generator=torch.Generator().manual_seed(2))
    ckpt = write_safetensors(str(tmp_path / "clip.safetensors"), {
        k: v.numpy() for k, v in hf_state_dict(text, vision).items()})
    labels = [f"label {i} the cat" if i % 3 else f"thé {i}"
              for i in range(130)]
    ours = provider.get_text_provider(ckpt, vp, mp, config=cfg, device=CPU)
    assert isinstance(ours, provider.CLIPTextEmbedder)
    got = ours(labels)
    want = jax_provider.get_text_provider(ckpt, vp, mp, config=jax_cfg)(
        labels)
    assert got.shape == (130, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(ours(labels[:2]), got[:2])
    assert isinstance(provider.get_text_provider(ckpt, None, mp, dim=16),
                      provider.HashTextEmbedder)


def _seg_loader(seed, n_batches=2, B=2, H=32, nc=8):
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((B, H, H, 3)).astype(np.float32),
             "segmentation": rng.integers(1, nc, (B, H, H)).astype(np.int32),
             "sample_valid": np.array([1.0, 0.0][:B], np.float32)}
            for _ in range(n_batches)]


def test_mask_clip_matches_jax():
    """The MaskCLIP prediction (patch tokens, bilinear upsample, cosine
    scores, candidate mask, top-k) against JAX's on the same tower, images
    and mask: ids equal up to near-ties; then evaluate_mask_clip over a
    loader gives finite metrics and the same ids as its prediction."""
    module, params, tower = _jax_tower("vision", 4)
    rng = np.random.default_rng(8)
    nc = 12
    table = rng.standard_normal((nc, 24)).astype(np.float32)
    batch = _seg_loader(9, 1)[0]
    seg = t(batch["segmentation"])
    mask = build_candidate_mask(seg, nc, 3,
                                generator=torch.Generator().manual_seed(0))
    images = clip_normalize(t(batch["image"]))
    text_n = torch.nn.functional.normalize(t(table), dim=-1)
    got = baselines.mask_clip_predict(tower, images, (32, 32), text_n, mask,
                                      top_k=3).numpy()

    patches = module.apply({"params": params}, jnp.asarray(images.numpy()),
                           True)
    dense = jax_l2_normalize(jax_resize_bilinear(patches, (32, 32)), axis=-1)
    logits = jnp.einsum("bhwd,cd->bhwc", dense,
                        jax_l2_normalize(jnp.asarray(table), axis=-1))
    logits = jnp.where(jnp.asarray(mask.numpy())[None, None, None], logits,
                       -1e30)
    want = np.asarray(jax.lax.top_k(logits, 3)[1])
    agree = got == want
    assert agree.mean() >= 0.99, agree.mean()
    if not agree.all():
        lg = np.asarray(logits)
        np.testing.assert_allclose(np.take_along_axis(lg, got, -1)[~agree],
                                   np.take_along_axis(lg, want, -1)[~agree],
                                   atol=1e-5)
    assert set(np.unique(got)) <= set(np.flatnonzero(mask.numpy()))

    eq = np.eye(nc, dtype=bool)
    res = baselines.evaluate_mask_clip(_seg_loader(9, 2), tower, table, eq,
                                       np.arange(nc), nc, num_negatives=3,
                                       top_k=3, seed=0)
    for key in ("mIoU_t1", "mIoU_tk", "pixel_accuracy_t1"):
        assert 0.0 <= res[key] <= 1.0, key


def _seg_former_case(name):
    """test_baselines.py's synthetic-logit cases: (loader, logits_fn,
    equivalence tensor)."""
    C, B, H = 8, 2, 8
    batches = _seg_loader(0, 1, B, H, C)
    b = batches[0]
    b["sample_valid"][:] = 1.0
    eq = np.eye(C, dtype=bool)
    if name == "oracle":
        fn = lambda images: np.eye(C, dtype=np.float32)[  # noqa: E731
            b["segmentation"]] * 10.0
    elif name == "low_res":
        blocks = np.random.default_rng(1).integers(1, C, (B, H // 4, H // 4))
        b["segmentation"] = np.kron(blocks, np.ones((4, 4))).astype(np.int32)
        small = b["segmentation"][:, ::2, ::2]
        fn = lambda images: np.eye(C, dtype=np.float32)[small] * 10.0  # noqa
    elif name == "padding":
        b["sample_valid"][1] = 0.0

        def fn(images):
            logits = np.eye(C, dtype=np.float32)[b["segmentation"]] * 10.0
            wrong = (b["segmentation"][1] % (C - 1)) + 1
            logits[1] = np.eye(C, dtype=np.float32)[wrong] * 10.0
            return logits
    else:  # equivalence-aware
        b["segmentation"][:] = 2
        fn = lambda images: (np.full((B, H, H, C), -1.0, np.float32)  # noqa
                             + 4.0 * np.eye(C, dtype=np.float32)[
                                 np.full((B, H, H), 5)])
        eq[2, 5] = eq[5, 2] = True
    return batches, fn, eq


@pytest.mark.parametrize("case", ["oracle", "low_res", "padding",
                                  "equivalence"])
def test_seg_former_matches_jax(case):
    """evaluate_seg_former on test_baselines.py's cases: the JAX pixel
    accuracy, and what those tests require of it."""
    batches, fn, eq = _seg_former_case(case)
    got = baselines.evaluate_seg_former(batches, fn, 8,
                                        equivalence_tensor=eq,
                                        num_negatives=8)
    want = jax_baselines.evaluate_seg_former(batches, fn, 8,
                                             equivalence_tensor=eq,
                                             num_negatives=8)
    assert abs(got - want) <= 1e-6, (got, want)
    if case == "low_res":
        assert got > 0.5
    else:
        assert got == 1.0


@pytest.mark.parametrize("case", ["padding", "equivalence"])
def test_seg_former_runs_where_the_logits_are(case):
    """A ``logits_fn`` returning tensors: the probe runs on their device
    (the host here) and gives the accuracy of the numpy form."""
    batches, fn, eq = _seg_former_case(case)
    want = baselines.evaluate_seg_former(batches, fn, 8,
                                         equivalence_tensor=eq,
                                         num_negatives=8)
    got = baselines.evaluate_seg_former(
        batches, lambda images: torch.from_numpy(fn(images)), 8,
        equivalence_tensor=eq, num_negatives=8)
    assert got == want


def test_hf_segformer_adapter_matches_jax(tmp_path, monkeypatch):
    """The HF SegFormer adapter on a tiny random SegFormer saved to disk:
    the same [B, h, w, C_model] logits as the JAX package's adapter (the
    port's a tensor on the adapter's device), and a pixel accuracy in
    [0, 1] through evaluate_seg_former."""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.SegformerConfig(
        num_channels=3, num_encoder_blocks=2, depths=[1, 1],
        sr_ratios=[2, 1], hidden_sizes=[8, 16], patch_sizes=[7, 3],
        strides=[4, 2], num_attention_heads=[1, 2], mlp_ratios=[2, 2],
        decoder_hidden_size=16, num_labels=8)
    transformers.SegformerForSemanticSegmentation(cfg).save_pretrained(
        str(tmp_path))
    transformers.SegformerImageProcessor(
        size={"height": 32, "width": 32}).save_pretrained(str(tmp_path))
    batches = _seg_loader(3, 1, 2, 32, 8)
    images = batches[0]["image"]
    got = baselines.hf_segformer_logits_fn(str(tmp_path), "cpu")(images)
    want = jax_baselines.hf_segformer_logits_fn(str(tmp_path))(images)
    assert got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    acc = baselines.evaluate_seg_former(
        batches, baselines.hf_segformer_logits_fn(str(tmp_path), "cpu"), 8,
        num_negatives=8)
    assert 0.0 <= acc <= 1.0
