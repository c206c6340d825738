"""Checkpointing: atomic, async, in the JAX package's on-disk format."""

from .checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
