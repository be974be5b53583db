"""Delta-coded versioned tensor payloads (container v4), as in
``repro.temporal``.

Version 0 of a v4 file is a full payload (keyframe); each later version
is a residual fitted against an earlier version's decode, and decodes as
the sum of its chain back to a keyframe:

    from repro_torch.codecs import load_file

    chain = load_file("run.tcdc")       # the latest version, on CUDA
    chain.decode_at(idx)                # float64 sum, keyframe first

Only the chain pieces are ported (``delta``); the versioned store and the
drift generator are not.
"""
from repro_torch.temporal.delta import (
    ChainEncoded,
    DeltaFitter,
    load_chain,
    resolve_chain,
)

__all__ = [
    "ChainEncoded",
    "DeltaFitter",
    "load_chain",
    "resolve_chain",
]
