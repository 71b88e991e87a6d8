"""Synthetic workloads (numpy only)."""
