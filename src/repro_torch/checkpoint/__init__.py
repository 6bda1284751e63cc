"""Atomic, async checkpoints in the JAX package's on-disk format (the port
of `repro.checkpoint`)."""
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 CheckpointCorruption,
                                                 latest_step, manifest,
                                                 migrate_flat_planes,
                                                 restore, restore_latest,
                                                 restore_network, save)

__all__ = ["AsyncCheckpointer", "CheckpointCorruption", "latest_step",
           "manifest", "migrate_flat_planes", "restore", "restore_latest",
           "restore_network", "save"]
