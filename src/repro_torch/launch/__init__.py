"""Launchers of the port: the LM serve path (serve.py)."""
