"""Synthetic traffic for the port's checks."""
