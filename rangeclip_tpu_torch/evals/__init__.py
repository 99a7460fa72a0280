"""Evaluation: equivalence-aware metrics, the validation harness and the
reference baselines (``rangeclip_tpu/evals/``)."""

from rangeclip_tpu_torch.evals.metrics import (
    metrics_finalize,
    metrics_init,
    metrics_update,
)

__all__ = ["metrics_init", "metrics_update", "metrics_finalize"]
