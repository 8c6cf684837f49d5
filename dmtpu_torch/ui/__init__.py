"""The logic of the JAX package's UI pages, without widgets: each module
holds what a page's buttons run, for a page of the port to call."""
