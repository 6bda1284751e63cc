"""Reusable experiment harnesses over the Simulator facade (the port of
`repro.experiments`).

`repro_torch.experiments.assoc_memory` is the associative-memory
train/cue/recall protocol that the recall server's users run and that the
DRAM-retention fault experiment re-runs under injected faults.
"""
from repro_torch.experiments.assoc_memory import (assoc_params, drive_frame,
                                                  recall_accuracy, sram_loss,
                                                  train_assoc,
                                                  winners_from_fired)

__all__ = ["assoc_params", "drive_frame", "recall_accuracy", "sram_loss",
           "train_assoc", "winners_from_fired"]
