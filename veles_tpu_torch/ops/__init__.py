"""Ops of the port: plain PyTorch versions (functional), the hand-written
Hopper kernels (kernels) and the lowering-variant registry (variants)."""
