"""The hybrid contrastive loss stack: pixel-text InfoNCE with curriculum
distractors, area-image InfoNCE, total-variation smoothness."""
