"""Utilities: device selection."""
