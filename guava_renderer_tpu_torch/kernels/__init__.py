"""Hand-written Hopper kernels and their wrappers.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (same module, same contract) for CPU tensors only; it
counts its kernel launches in a module-level `launches` integer.
"""
