"""Synthetic data streams of the port (the port of `repro.data`)."""
from repro_torch.data.synthetic import (MarkovLM, lm_batch_spec, make_patterns,
                                        pattern_drive, poisson_external_drive)

__all__ = ["MarkovLM", "lm_batch_spec", "make_patterns", "pattern_drive",
           "poisson_external_drive"]
