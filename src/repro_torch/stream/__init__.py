"""Out-of-core streaming compression, as in ``repro.stream``: fit tensors
that never fit in memory at once.

The paper's scalability claim (§V-D) is that compression time is linear
in the number of entries.  Tensors arrive as ``(indices, values)`` slabs
from a :class:`SlabSource` (dense array, memory-mapped file, or seeded
synthetic generator), and ``fit_stream`` drives a codec's incremental
fitter over them:

    from repro_torch.stream import SyntheticTensorSource, fit_stream, write_chunked

    src = SyntheticTensorSource((4096, 64, 64), slab_entries=1 << 18)
    enc = fit_stream("nttd", src, rank=6, hidden=12)   # on CUDA, never densifies
    write_chunked("payload.tcdc", enc)                 # chunked container

NTTD warm-starts its minibatched SGD (paper §IV-B Alg. 2) over arriving
slabs with a reservoir replay buffer, on the card through the
hand-written kernels; TT gets a TT-ICE-style incremental basis expansion
(Aksoy et al.) on the host; every other codec falls back to
accumulate-then-``fit`` via the default ``Codec.fit_stream`` hook.
Modules: ``source`` (slab protocol + sources), ``fit`` (incremental
fitters), ``writer`` (chunked container writer).
"""
from repro_torch.stream.fit import NTTDStreamFitter, TTICEStreamFitter, fit_stream
from repro_torch.stream.source import (
    DenseSource,
    MMapTensorSource,
    Slab,
    SlabSource,
    SyntheticTensorSource,
    write_tensor_file,
)
from repro_torch.stream.writer import (
    ChunkedWriter,
    append_patch,
    rewrite_chunks,
    sample_heldout,
    write_chunked,
)

__all__ = [
    "ChunkedWriter",
    "append_patch",
    "rewrite_chunks",
    "DenseSource",
    "MMapTensorSource",
    "NTTDStreamFitter",
    "Slab",
    "SlabSource",
    "SyntheticTensorSource",
    "TTICEStreamFitter",
    "fit_stream",
    "sample_heldout",
    "write_chunked",
    "write_tensor_file",
]
