"""Training: AdamW and LR schedules, the train step and loop, and
checkpoints in the reference's on-disk format."""
