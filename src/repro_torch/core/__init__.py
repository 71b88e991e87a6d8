"""Model structure, quantization, layout and prediction plans."""
