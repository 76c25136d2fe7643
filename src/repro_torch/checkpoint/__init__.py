"""repro_torch.checkpoint — atomic, async, layout-free checkpoints."""

from .checkpoint import (  # noqa: F401
    CheckpointManager, latest_step, restore, save,
)
