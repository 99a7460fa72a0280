"""Training: curriculum, optimizer and schedules, train state, train
step, checkpoints, trainer loop."""
