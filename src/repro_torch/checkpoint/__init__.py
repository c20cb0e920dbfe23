"""Model-state checkpoints (reference ``checkpoint/``)."""
from .manager import CheckpointIntegrityError, CheckpointManager

__all__ = ["CheckpointIntegrityError", "CheckpointManager"]
