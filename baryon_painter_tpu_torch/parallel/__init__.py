"""Whole-plane painting (``spatial.py``); one device, multi-GPU to come."""
