"""Weights across frameworks: flax trees and reference checkpoints."""
from . import weights  # noqa: F401
from .weights import from_jax_params, load_reference_checkpoint  # noqa: F401
