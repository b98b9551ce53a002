"""Meshes (``mesh.py``) and whole-plane painting (``spatial.py``)."""
