"""Architecture configs (copied from the reference package; plain Python)."""
