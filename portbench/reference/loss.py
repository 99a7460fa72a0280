"""The plain reference of the hybrid loss and of one train step.

Loss (jinryan/RangeCLIP ``utils/src/loss``, in the native-resolution form
that scores the H/2 field against full-resolution labels: every term of
the nearest x2 upsampled field is a weighted sum over the native one):

* text: each image's pixels sampled with replacement, ``percent`` of them,
  by the draws the benchmark hands in; a pixel's weight is its count where
  its label is not 0.  The contrast set is the labels present under a
  weight, ``n_medium + n_hard`` distractors drawn by Gumbel top-n from
  the pooled medium and hard similarity sets of the present labels, and
  ``n_rand`` from the rest.  The weighted mean cross-entropy of
  cos(pixel, text) / tau_text over the contrast members;
* image: each map's area embedding (the mean of the field over its object
  label's pixels) against every image embedding, diagonal InfoNCE over
  tau_image;
* smoothness: mean |dx| + mean |dy| of the field, each rescaled to the
  pair count of the upsampled field;
* total = w_text * text + w_image * image + w_smooth * smoothness.

The step: the field's gradient is taken term by term on a detached leaf
(the cross-entropy a few images at a time, so that its [pixels, members]
logits fit), then pushed back through the network; Adam (beta 0.9, 0.999,
eps 1e-8, no weight decay) moves every parameter that has a gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import Net, Params, Round, trainable


def distractor_counts(k: int, pct_medium: float, pct_hard: float
                      ) -> Tuple[int, int, int]:
    """floor(k * pct) in float32 for the medium and hard draws, the rest
    random."""
    kk = np.float32(k)
    n_medium = int(np.floor(kk * np.float32(pct_medium)))
    n_hard = int(np.floor(kk * np.float32(pct_hard)))
    return n_medium, n_hard, k - n_medium - n_hard


def pixel_weights(seg: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    """[B, H, W] f32: how often each pixel was drawn, 0 where its label is
    0."""
    B, H, W = seg.shape
    counts = torch.zeros(B, H * W, device=seg.device)
    counts.scatter_add_(1, pixels.long(),
                        torch.ones(pixels.shape, device=seg.device))
    return counts.reshape(B, H, W) * (seg > 0)


def _top_n(pool: torch.Tensor, n: int, noise: torch.Tensor) -> torch.Tensor:
    """The members of ``pool`` whose noise is among its n largest (the
    whole pool when it has fewer; nothing for n == 0)."""
    if n <= 0:
        return torch.zeros_like(pool)
    scores = torch.where(pool, noise, torch.full_like(noise, -math.inf))
    top = torch.sort(scores, descending=True).values
    return pool & (scores >= top[min(n, pool.numel()) - 1])


def contrast_mask(seg: torch.Tensor, weights: torch.Tensor, num_classes: int,
                  medium: torch.Tensor, hard: torch.Tensor, k: int,
                  pct_medium: float, pct_hard: float,
                  gumbel: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """[C] bool: the present labels plus the drawn distractors."""
    present = torch.zeros(num_classes, dtype=torch.bool, device=seg.device)
    present[seg[weights > 0].long()] = True
    n_medium, n_hard, n_rand = distractor_counts(k, pct_medium, pct_hard)
    pf = present.float()
    medium_union = (pf @ medium.float()) > 0
    hard_union = (pf @ hard.float()) > 0
    pool = ((medium_union & (n_medium > 0)) | (hard_union & (n_hard > 0))) \
        & ~present
    chosen = _top_n(pool, n_medium + n_hard, gumbel[0].float())
    chosen_rand = _top_n(~present & ~chosen, n_rand, gumbel[1].float())
    return present | chosen | chosen_rand


def text_ce_sum(field: torch.Tensor, seg: torch.Tensor,
                weights: torch.Tensor, table_n: torch.Tensor,
                members: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """sum over full-resolution pixels of weight * CE, for the native
    field [b, h, w, D] of these images (labels and weights [b, 2h, 2w])."""
    b, h, w, D = field.shape
    ids = members.nonzero().squeeze(1)
    pos = torch.full((members.numel(),), -1, dtype=torch.long,
                     device=field.device)
    pos[ids] = torch.arange(ids.numel(), device=field.device)
    emb = F.normalize(field.reshape(-1, D), dim=-1, eps=1e-12)
    logits = (emb @ table_n[ids].T) / tau
    lse = torch.logsumexp(logits, dim=1)
    s = seg.shape[1] // h
    lab = seg.reshape(b, h, s, w, s).permute(2, 4, 0, 1, 3).reshape(s * s,
                                                                    -1)
    wt = weights.reshape(b, h, s, w, s).permute(2, 4, 0, 1, 3).reshape(
        s * s, -1)
    total = field.new_zeros(())
    for slot in range(s * s):
        # a weighted label is always a member; others weigh 0
        col = pos[lab[slot].long()].clamp_min(0)[:, None]
        picked = logits.gather(1, col).squeeze(1)
        total = total + (wt[slot] * (lse - picked)).sum()
    return total


def area_embeddings(field: torch.Tensor, seg: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """[B, D]: each map's field averaged over its label's pixels at full
    resolution (a native pixel counts once per matching child)."""
    B, h, w, _ = field.shape
    s = seg.shape[1] // h
    mask = (seg == labels[:, None, None]).float().reshape(
        B, h, s, w, s).sum(dim=(2, 4))
    sums = torch.einsum("bhw,bhwd->bd", mask, field)
    counts = mask.sum(dim=(1, 2))[:, None]
    return torch.where(counts > 0, sums / counts.clamp_min(1.0),
                       torch.zeros_like(sums))


def image_infonce(area: torch.Tensor, image: torch.Tensor,
                  valid: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    a = F.normalize(area, dim=-1, eps=1e-12)
    i = F.normalize(image.float(), dim=-1, eps=1e-12)
    logits = (a @ i.T) / tau
    logits = torch.where(valid[None, :] > 0, logits,
                         torch.full_like(logits, -1e30))
    ce = torch.logsumexp(logits, dim=-1) - torch.diagonal(logits)
    n = valid.sum()
    loss = (ce * valid).sum() / n.clamp_min(1.0)
    return torch.where(n > 1, loss, torch.zeros_like(loss))


def smoothness(field: torch.Tensor, s: int) -> torch.Tensor:
    _, h, w, _ = field.shape
    tv_h = (field[:, :, :-1] - field[:, :, 1:]).abs().mean()
    tv_v = (field[:, :-1] - field[:, 1:]).abs().mean()
    return (tv_h * ((w - 1) / (s * w - 1))
            + tv_v * ((h - 1) / (s * h - 1)))


class StepResult:
    def __init__(self, loss: float, grads: Dict[str, torch.Tensor],
                 members: int):
        self.loss, self.grads, self.members = loss, grads, members


def loss_and_grads(cfg: dict, cell: dict, params: Params, batch: dict,
                   draws: dict, text: torch.Tensor, medium: torch.Tensor,
                   hard: torch.Tensor, q: Round = None,
                   images_per_chunk: int = 8) -> StepResult:
    """One microbatch: the loss value and the gradient of every parameter
    (float32, TF32 off is the caller's), with ``q`` the control's
    rounding."""
    loss_cfg = cell["loss"]
    leaves = {k: v.detach().clone().requires_grad_(True)
              if k in set(trainable(params)) else v
              for k, v in params.items()}
    net = Net(cfg, leaves, train=True, q=q)
    field = net.field(batch["depth"])
    f = field.detach().requires_grad_(True)
    seg = batch["segmentation"]
    B = seg.shape[0]
    s = seg.shape[1] // f.shape[1]
    weights = pixel_weights(seg, draws["pixels"])
    members = contrast_mask(seg, weights, text.shape[0], medium, hard,
                            int(loss_cfg["k_distractors"]),
                            cell["pct_medium"], cell["pct_hard"],
                            draws["gumbel"])
    n_valid = weights.sum()
    table_n = F.normalize(text.float(), dim=-1, eps=1e-12)
    gate = bool(members.sum() > 1) and bool(n_valid > 0)
    total = 0.0
    w_text = float(loss_cfg["w_text"])
    if gate and w_text > 0:
        for lo in range(0, B, images_per_chunk):
            hi = min(lo + images_per_chunk, B)
            # the temperature's graph is taken anew for each backward
            tau_t = leaves["log_temperature_text"].exp()
            part = text_ce_sum(f[lo:hi], seg[lo:hi], weights[lo:hi],
                               table_n, members, tau_t)
            term = part * (w_text / n_valid)
            term.backward()
            total += float(term.detach())
    valid = batch["sample_valid"].float()
    area = area_embeddings(f, seg, batch["object_label"])
    tau_i = leaves["log_temperature_image"].exp()
    rest = (float(loss_cfg["w_image"])
            * image_infonce(area, batch["image_embeddings"], valid, tau_i)
            + float(loss_cfg["w_smooth"]) * smoothness(f, s))
    rest.backward()
    total += float(rest.detach())
    field.backward(f.grad)
    grads = {k: v.grad for k, v in leaves.items()
             if isinstance(v, torch.Tensor) and v.requires_grad
             and v.grad is not None}
    return StepResult(total, grads, int(members.sum()))


class Adam:
    """torch's Adam formula, kept apart from the program's optimizer."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t: Dict[str, int] = {}

    def step(self, params: Params, grads: Dict[str, torch.Tensor]) -> None:
        for name, g in grads.items():
            m = self.m.setdefault(name, torch.zeros_like(g))
            v = self.v.setdefault(name, torch.zeros_like(g))
            t = self.t[name] = self.t.get(name, 0) + 1
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v.sqrt() / math.sqrt(1 - self.b2 ** t)).add_(self.eps)
            params[name] = params[name] - (self.lr / (1 - self.b1 ** t)) \
                * m / denom


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def reference_steps(cfg: dict, cell: dict, params: Params,
                    batches: List[dict], draws: List[dict],
                    text: torch.Tensor, medium: torch.Tensor,
                    hard: torch.Tensor, q: Round = None
                    ) -> Dict[str, object]:
    """The reference's first steps over ``batches``: each step's loss, the
    first gradient's leaf norms, and the leaf norms of the parameters'
    change after the last step."""
    p = dict(params)
    start = {k: p[k].detach().clone() for k in trainable(p)}
    adam = Adam(float(cell["learning_rate"]))
    losses, first = [], None
    for batch, d in zip(batches, draws):
        r = loss_and_grads(cfg, cell, p, batch, d, text, medium, hard, q)
        losses.append(r.loss)
        if first is None:
            first = leaf_norms(r.grads)
        adam.step(p, r.grads)
        del r
    change = leaf_norms({k: p[k] - start[k] for k in start})
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def forward_field(cfg: dict, params: Params, depth: torch.Tensor,
                  train: bool, q: Round = None,
                  stats: Optional[dict] = None) -> torch.Tensor:
    """The normalised native field without gradients."""
    with torch.no_grad():
        net = Net(cfg, params, train=train, q=q)
        out = net.field(depth)
        if stats is not None:
            stats.update(net.stats)
        return out
