"""Kernels: hand-written CUDA C++ for Hopper (``csrc/``), their ctypes
wrappers, the plain PyTorch versions and oracles (``ref``) and the
dispatcher (``ops``)."""
