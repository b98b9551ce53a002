"""Checkpoint reading (the training engine is not ported yet)."""
