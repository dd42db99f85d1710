"""Checkpoint substrate: atomic, verified, async save/restore (port of
``repro.checkpoint``)."""

from .manager import (
    CheckpointManager,
    CorruptCheckpointError,
    latest_step,
    restore,
    save,
)

__all__ = ["CheckpointManager", "CorruptCheckpointError", "latest_step",
           "restore", "save"]
