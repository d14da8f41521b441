"""Training: losses, the pipeline's loss function, the train step, checkpoints."""
