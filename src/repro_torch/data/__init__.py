"""Synthetic workloads."""
