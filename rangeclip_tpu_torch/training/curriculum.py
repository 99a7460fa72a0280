"""Curriculum schedule for distractor composition (a copy of
``rangeclip_tpu/training/curriculum.py``, pinned to it by a test).

Reference: train_util.py:52-62 —
  pct_medium: 1.0 -> 0.0 over the first 25% of training,
  pct_hard:   0.0 -> 0.8 linearly (clipped),
  pct_rand:   the remainder; all rounded to 4 decimals.
"""

from __future__ import annotations

from typing import Dict


def get_curriculum_schedule(epoch: int, total_epochs: int) -> Dict[str, float]:
    pct = epoch / total_epochs
    pct_medium = max(0.0, 1.0 - 4.0 * pct)
    pct_hard = min(0.8, pct * 1.2)
    pct_rand = 1.0 - pct_medium - pct_hard
    return {
        "pct_medium": round(pct_medium, 4),
        "pct_hard": round(pct_hard, 4),
        "pct_rand": round(pct_rand, 4),
    }
