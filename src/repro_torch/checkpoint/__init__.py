"""Checkpoint substrate of the port: save/restore with a manifest, async
save, and a preemption (SIGTERM) hook.  Port of ``repro/checkpoint``; the
on-disk format is the reference's, so each package restores the other's
checkpoints."""

from .sharded import (CheckpointManager, save_checkpoint, restore_checkpoint,
                      latest_step, manifest_target)
from .preemption import PreemptionGuard

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step", "manifest_target", "PreemptionGuard"]
