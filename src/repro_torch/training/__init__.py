"""Training: quantized-first boosting and its checkpoints."""
