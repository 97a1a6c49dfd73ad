"""Training: losses, LR schedule, checkpoints, the Trainer and its CLI."""
from . import checkpoint, losses, schedule  # noqa: F401
from .loop import Trainer  # noqa: F401
