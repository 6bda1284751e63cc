"""PyTorch/CUDA port of the eBrainII BCPNN reproduction (`repro`).

Laid out module for module like the JAX package `repro`, which stays the
reference the port is tested against. The port imports neither JAX nor
`repro`. Its entry points run on CUDA unless the caller passes
``device="cpu"``; there, every kernel runs as its plain PyTorch version.

Ported so far:

* the local lazy and eager BCPNN tick on one device, with every backend
  the JAX package has for it (`repro_torch.core.engine.Simulator`), on
  flat or column-blocked (Row-Merge) planes (`repro_torch.core.layout`),
  and the five BCPNN update kernels as hand-written Hopper kernels;
* merged mode (`repro_torch.core.merged`) and checkpoints in the JAX
  package's on-disk format (`repro_torch.checkpoint`);
* resilience (`repro_torch.runtime`: `ResilientRunner`'s crash recovery
  with bitwise replay, DRAM-retention faults `flip_bits` /
  `inject_retention_faults`, the drop-budget `HealthMonitor`), the
  associative-memory protocol (`repro_torch.experiments`) and BCPNN
  recall serving (`repro_torch.launch.serve_bcpnn.BCPNNRecallServer`,
  session lanes `stack_sessions` / `write_sessions` / `take_session`);
* LM serving for every family of the JAX package (`repro_torch.models`,
  `repro_torch.train.serve_step`, `repro_torch.launch.serve.ServingEngine`),
  with prefill attention as a hand-written Hopper flash-attention kernel;
* the synthetic data streams (`repro_torch.data`) and LM training on one
  device (`repro_torch.train`: AdamW, the train step with remat;
  `repro_torch.launch.train`), whose checkpoints each package restores.

All six kernels live in `repro_torch.kernels`. ROADMAP.md lists what is
still to port.
"""
