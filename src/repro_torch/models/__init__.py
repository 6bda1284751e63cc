"""LM substrate of the port: config schema, layers, MoE and recurrent
mixers, and model assembly for every family."""
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import Model, build_stack_spec

__all__ = ["ArchConfig", "Model", "build_stack_spec"]
