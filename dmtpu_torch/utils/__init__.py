"""Utilities: the optimizer factories."""
