"""Checkpoints of the train state (``rangeclip_tpu/training/checkpoint.py``).

The model is written as a reference ``.pth`` (``models/interop.
save_reference_pth``: ``{train_step, encoder, decoder, log_temperature_text,
log_temperature_image}``) under the reference's name template
``depth_segmentation_model-{step}.pth`` (train_util.py:552-556), so
``cli/serve`` and ``cli/infer`` load a trained checkpoint as they are; the
optimizer state and the step go beside it in ``optimizer-{step}.pt``.
Restore keeps the optimizer state (the reference discards it);
:meth:`CheckpointManager.restore_encoder` takes only the encoder's weights
and BatchNorm statistics (the frozen-encoder finetune).  Each file
is written under a temporary name and renamed, so a checkpoint is listed
only once both files are whole.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from rangeclip_tpu_torch.models.interop import (
    load_reference_pth,
    save_reference_pth,
)
from rangeclip_tpu_torch.training.state import TrainState

MODEL_FILE = "depth_segmentation_model-{step}.pth"
OPTIMIZER_FILE = "optimizer-{step}.pt"
_STEP = re.compile(r"^optimizer-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, checkpoint_dir: str):
        self.directory = os.path.abspath(checkpoint_dir)

    def model_path(self, step: int) -> str:
        return os.path.join(self.directory, MODEL_FILE.format(step=step))

    def optimizer_path(self, step: int) -> str:
        return os.path.join(self.directory, OPTIMIZER_FILE.format(step=step))

    def save(self, state: TrainState) -> str:
        """Write the model .pth and the optimizer state at ``state.step``;
        returns the .pth path."""
        os.makedirs(self.directory, exist_ok=True)
        step = int(state.step)
        path = self.model_path(step)
        save_reference_pth(state.model, path + ".tmp", train_step=step)
        os.replace(path + ".tmp", path)
        opt = self.optimizer_path(step)
        torch.save({"step": step, "optimizer": state.optimizer.state_dict()},
                   opt + ".tmp")
        os.replace(opt + ".tmp", opt)
        return path

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.directory):
            return None
        steps = [int(m.group(1)) for m in map(_STEP.match,
                                               os.listdir(self.directory))
                 if m and os.path.exists(self.model_path(int(m.group(1))))]
        return max(steps) if steps else None

    def restore(self, state: TrainState) -> TrainState:
        """Load the latest checkpoint's model (``strict=True``), optimizer
        state and step into ``state``.  The optimizer's hyperparameters
        (weight decay, betas, eps) stay the running ones, as an optax
        state carries none: a checkpoint that ``cli/convert`` imported with
        fresh Adam state resumes under the resuming run's flags."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        device = next(state.model.parameters()).device
        state.model.load_state_dict(load_reference_pth(self.model_path(step)),
                                    strict=True)
        saved = torch.load(self.optimizer_path(step), map_location=device,
                           weights_only=True)
        running = [{k: v for k, v in group.items() if k != "params"}
                   for group in state.optimizer.param_groups]
        state.optimizer.load_state_dict(saved["optimizer"])
        for group, hyper in zip(state.optimizer.param_groups, running):
            group.update(hyper)
        state.step = int(saved["step"])
        return state

    def restore_encoder(self, state: TrainState) -> TrainState:
        """Encoder-only restore (``restore_encoder_params``,
        checkpoint.py:94-120): the latest checkpoint's ``encoder.*``
        weights and BatchNorm running statistics replace the model's;
        the decoder, the temperatures, the optimizer state and the step
        stay as initialised, so the source run's optimizer need not match
        this one."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        merged = state.model.state_dict()
        encoder = {k: v for k, v in load_reference_pth(
            self.model_path(step)).items() if k.startswith("encoder.")}
        if set(encoder) != {k for k in merged if k.startswith("encoder.")}:
            raise KeyError(f"{self.model_path(step)}: its encoder is not "
                           "this model's")
        merged.update(encoder)
        state.model.load_state_dict(merged, strict=True)
        return state
