"""Training: the CVAE step (``trainer.py``), schedules, statistics
bookkeeping, and checkpoint reading."""
