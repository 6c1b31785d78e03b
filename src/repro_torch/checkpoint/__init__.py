"""See the matching subpackage of the JAX reference package."""
from .ckpt import (CheckpointManager, load_numpy_tree, load_pytree,
                   save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "load_numpy_tree"]
