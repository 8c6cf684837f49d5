"""Utilities: config, image output, logging and the optimizer factories."""
