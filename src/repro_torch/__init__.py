"""PyTorch/CUDA port of the eBrainII BCPNN reproduction (`repro`).

Laid out module for module like the JAX package `repro`, which stays the
reference the port is tested against. The port imports neither JAX nor
`repro`. Its entry points run on CUDA unless the caller passes
``device="cpu"``; there, every kernel runs as its plain PyTorch version.

Ported so far: the lazy worklist BCPNN tick on one device
(`repro_torch.core.engine.Simulator`), with the row and column phases as
hand-written Hopper kernels (`repro_torch.kernels`). ROADMAP.md lists what
is still to port.
"""
