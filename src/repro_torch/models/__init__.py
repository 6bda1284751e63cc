"""LM substrate of the port: the dense-family transformer (config schema,
layers, model assembly)."""
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import Model, build_stack_spec

__all__ = ["ArchConfig", "Model", "build_stack_spec"]
