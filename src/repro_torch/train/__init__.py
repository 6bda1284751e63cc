"""Serving steps of the port (training is not ported yet: ROADMAP queue A
item 8)."""
from repro_torch.train.serve_step import (generate, make_decode_step,
                                          make_prefill, sample)

__all__ = ["generate", "make_decode_step", "make_prefill", "sample"]
