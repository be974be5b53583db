"""PyTorch/CUDA port of the TensorCodec package ``repro``.

The layout mirrors ``repro`` module for module (``repro_torch.core.nttd``
is the counterpart of ``repro.core.nttd``).  The package imports torch and
numpy only.  Its entry points (``codecs.load_bytes``, ``decode_at``,
``to_dense``) run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA and without an explicit device they raise.

On a CUDA tensor the three decode kernels (``kernels/csrc/*.cu``) are
hand-written CUDA C++ for Hopper, built with ``nvcc`` at first use; on a
CPU tensor each wrapper runs its plain PyTorch version (``kernels/ref.py``).
"""
