"""Deterministic synthetic LM data (numpy batches)."""
