"""Hand-written Hopper kernels of the port (CUDA C++ in `csrc/`, built at
first use by `_build`), their plain PyTorch versions (`bcpnn_update`,
`bcpnn_ref`) and the device dispatch (`ops`)."""
