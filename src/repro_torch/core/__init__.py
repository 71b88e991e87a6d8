"""Model structure, quantization, layout, prediction plans, losses and
boosting."""
