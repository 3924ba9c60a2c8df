"""Atomic, keep-K, async checkpoints in the reference's on-disk layout."""
