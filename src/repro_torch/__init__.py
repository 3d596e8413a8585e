"""PyTorch / CUDA port of the Winograd DeConv GAN system for NVIDIA Hopper.

Mirrors the reference package's module names and array layouts (NHWC
images, packed (C, N, M) weights, (B, Gy, Gx, m*m, N) cells, the same
param keys).  Entry points run on the card unless the caller passes
``device="cpu"``; CPU tensors take each kernel's plain PyTorch version.
"""
