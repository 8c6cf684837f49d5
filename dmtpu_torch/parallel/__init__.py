"""The train step (one card; data-parallel and sharded training are not ported)."""
from dmtpu_torch.parallel.train import (
    TrainState,
    make_diffusion_loss_fn,
    make_train_step,
    step_generator,
)

__all__ = ["TrainState", "make_diffusion_loss_fn", "make_train_step", "step_generator"]
