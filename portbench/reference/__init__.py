"""Plain PyTorch references of what the cells run, float32, written from the
published models and algorithms.  Nothing here imports the program under
test: the check builds these from the configuration files and the
benchmark's own weights and inputs."""
