"""Weights and optimizer state across frameworks: flax trees, optax states
and reference checkpoints."""
from . import weights  # noqa: F401
from .weights import (from_jax_opt_state, from_jax_params, load_reference_checkpoint,  # noqa: F401
                      to_jax_opt_state, to_jax_params)
