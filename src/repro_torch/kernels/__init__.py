"""Decode kernels: hand-written CUDA C++ for Hopper (``csrc/``), their
ctypes wrappers, the plain PyTorch oracles (``ref``) and the dispatcher
(``ops``)."""
