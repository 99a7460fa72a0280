"""The plain reference of the labels-only predict: the candidate set, the
field in eval mode (BatchNorm over its running statistics), the cosine
scores of its native pixels against the live candidates, and the widest
gap by which the program's picks fall below the reference's best.

A folded or fused head ranks the same classes as the unfolded
normalise-then-score head: the output conv is linear and bias-free and a
pixel's normalisation scales all its scores alike.  So the program's
top-k, read at a native pixel (the top-left child of its nearest x2
upsample), is judged by the reference's scores of those classes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .model import Net, Params, Round


def calibrated_statistics(cfg: dict, params: Params,
                          depth: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Running statistics for eval mode: every BatchNorm's batch mean and
    biased variance over ``depth``'s maps, in float32."""
    with torch.no_grad():
        net = Net(cfg, params, train=True)
        net.field(depth)
    out = {}
    for name, (mean, var) in net.stats.items():
        out[f"{name}.running_mean"] = mean.float()
        out[f"{name}.running_var"] = var.float()
    return out


def candidates(seg: torch.Tensor, num_classes: int, negatives: int,
               noise: torch.Tensor, slots: int) -> torch.Tensor:
    """The live candidate ids, ascending: the labels present in the batch
    and the ``negatives`` absent classes of largest noise, the first
    ``slots`` of them."""
    present = torch.zeros(num_classes, dtype=torch.bool, device=seg.device)
    present[seg.reshape(-1).long()] = True
    scores = torch.where(present, torch.full_like(noise, -float("inf")),
                         noise.float())
    picked = scores.topk(min(negatives, num_classes)).indices
    mask = present.clone()
    mask[picked[torch.isfinite(scores[picked])]] = True
    return mask.nonzero().squeeze(1)[:slots]


def native_fields(cfg: dict, params: Params, depth: torch.Tensor,
                  q: Round = None, block: int = 8) -> torch.Tensor:
    """The eval-mode normalised native field of each map, a block of maps
    at a time."""
    with torch.no_grad():
        return torch.cat([Net(cfg, params, train=False, q=q).field(
            depth[i:i + block]) for i in range(0, depth.shape[0], block)])


def gaps(field: torch.Tensor, picks: torch.Tensor, live: torch.Tensor,
         table_n: torch.Tensor) -> torch.Tensor:
    """[n] the largest gap of each pixel's k picks: the reference's k-th
    best score less its score of the k-th pick (2, the widest a cosine
    gap can be, where a pick is no live candidate)."""
    scores = field @ table_n[live].T  # [n, S]
    best = scores.sort(dim=1, descending=True).values[:, :picks.shape[1]]
    pos = torch.full((table_n.shape[0],), -1, dtype=torch.long,
                     device=field.device)
    pos[live] = torch.arange(live.numel(), device=field.device)
    slot = pos[picks.long().clamp(0, table_n.shape[0] - 1)]
    ok = (picks >= 0) & (picks < table_n.shape[0]) & (slot >= 0)
    got = scores.gather(1, slot.clamp_min(0))
    gap = torch.where(ok, best - got, torch.full_like(got, 2.0))
    return gap.max(dim=1).values


def answer_gaps(cfg: dict, cell: dict, params: Params, inputs,
                answers: Dict[int, torch.Tensor], pool: int,
                rng: np.random.Generator, q: Round = None
                ) -> Dict[str, float]:
    """The gaps of a sample of the answers: for each kept call, ``maps``
    maps and ``pixels`` native pixels in each, drawn from ``rng``.
    ``score_gap`` is the widest of them, ``score_gap_mean`` their mean
    and ``score_gap_p99`` their 99th percentile."""
    check = cell["check"]
    C = int(cfg["num_classes"])
    table_n = F.normalize(inputs.text.float(), dim=-1)
    every = []
    for call, ids in sorted(answers.items()):
        b = inputs.batches[call % pool]
        d = inputs.draws[call % pool]
        live = candidates(b["segmentation"], C, int(cell["negatives"]),
                          d["gumbel"][0], int(cell["slots"]))
        B, H, W, k = ids.shape
        maps = torch.as_tensor(rng.choice(B, int(check["maps"]),
                                          replace=False),
                               device=ids.device)
        field = native_fields(cfg, params, b["depth"][maps], q)
        h, w = field.shape[1:3]
        s = H // h
        n = int(check["pixels"])
        rows = torch.as_tensor(rng.integers(0, h, (len(maps), n)),
                               device=ids.device)
        cols = torch.as_tensor(rng.integers(0, w, (len(maps), n)),
                               device=ids.device)
        idx = torch.arange(len(maps), device=ids.device)[:, None]
        picks = ids[maps[:, None], rows * s, cols * s].reshape(-1, k)
        f = field[idx, rows, cols].reshape(-1, field.shape[-1])
        every.append(gaps(f, picks, live, table_n))
    every = torch.cat(every).double()
    return {"score_gap": float(every.max()),
            "score_gap_mean": float(every.mean()),
            "score_gap_p99": float(torch.quantile(every, 0.99))}


def reference_picks(cfg: dict, cell: dict, params: Params, depth,
                    live: torch.Tensor, table_n: torch.Tensor,
                    q: Round) -> torch.Tensor:
    """[B, h, w, k] the top-k candidate ids of a field computed with the
    rounding ``q`` (the control in the program's place)."""
    field = native_fields(cfg, params, depth, q)
    scores = field @ table_n[live].T
    top = scores.topk(int(cell["top_k"]), dim=-1).indices
    return live[top].to(torch.int32)
