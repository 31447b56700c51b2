"""repro_torch.kernels — hand-written Hopper kernels (``csrc/``), their
Python wrappers with plain PyTorch versions, and the backend registry."""
