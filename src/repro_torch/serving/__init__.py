"""Batched serving over a prediction plan."""
