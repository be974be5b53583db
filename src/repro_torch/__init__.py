"""PyTorch/CUDA port of the TensorCodec package ``repro``.

The layout mirrors ``repro`` module for module (``repro_torch.core.nttd``
is the counterpart of ``repro.core.nttd``).  The package imports torch and
numpy only.  Its entry points (``codecs.load_bytes``, ``decode_at``,
``to_dense``, ``models.model.init_params``, ``launch.serve``) run on the
CUDA device unless the caller passes ``device="cpu"``; without CUDA and
without an explicit device they raise.

Ported so far: the six codecs and their container (NTTD decode and
fitting on the card), out-of-core streaming compression (``stream``),
delta chains (``temporal``) and dense LM serving.  On a CUDA tensor the
four kernels (``kernels/csrc/*.cu``: the fused decode, the
LSTM scan, the TT chain and flash attention) are hand-written CUDA C++ for
Hopper, built with ``nvcc`` at first use; on a CPU tensor each wrapper
runs its plain PyTorch version (``kernels/ref.py``).
"""
