"""Development probes of the port's kernels: scripts that run on a CUDA card."""
