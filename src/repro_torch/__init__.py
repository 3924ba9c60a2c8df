"""PyTorch/CUDA port of the integer recurrent-LM serving stack.

Mirrors ``src/repro/``'s layout module for module.  It imports ``torch`` and
``numpy`` only: nothing of JAX and nothing of the JAX package, whose
integer tensors it reproduces bit for bit.  Kernels are hand-written CUDA
C++ for Hopper (``csrc/``), built with ``nvcc`` on first use; a CPU tensor
takes each kernel's plain PyTorch version instead.
"""
