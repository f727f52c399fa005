"""PyTorch/CUDA port of ``myrtlespeech_tpu`` for NVIDIA Hopper (H100).

It imports torch and numpy, never JAX and nothing of the JAX package.  The
module layout follows the JAX package so that each counterpart is easy to
find; see README.md, "PyTorch / H100 port".
"""
