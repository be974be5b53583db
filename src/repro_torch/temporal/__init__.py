"""Delta-coded versioned tensor payloads (container v4), as in
``repro.temporal``.

Version 0 of a v4 file is a full payload (keyframe); each later version
is a residual fitted against an earlier version's decode, and decodes as
the sum of its chain back to a keyframe:

    from repro_torch.temporal import VersionedStore, drifting_versions

    with VersionedStore.create("run.tcdc", codec="nttd") as store:
        for x in drifting_versions((24, 16, 16), 8, seed=11):
            store.append(x)                 # NTTD fits on CUDA unless device=

    reader = VersionedStore.open("run.tcdc")
    reader.decode_at(idx, version=3)        # float64 sum, keyframe first

Modules: ``delta`` (chains and the residual fitter), ``store`` (the
writer, the eager reader and chain revalidation) and ``drift`` (the
drifting sequences of the temporal benchmark).  The same files serve
lazily through ``repro_torch.serve.codec_service.CodecService``.
"""
from repro_torch.temporal.delta import (
    ChainEncoded,
    DeltaFitter,
    load_chain,
    resolve_chain,
)
from repro_torch.temporal.drift import drifting_versions
from repro_torch.temporal.store import (
    ChainHealth,
    VersionedReader,
    VersionedStore,
    revalidate_chains,
)

__all__ = [
    "ChainEncoded",
    "ChainHealth",
    "DeltaFitter",
    "VersionedReader",
    "VersionedStore",
    "drifting_versions",
    "load_chain",
    "resolve_chain",
    "revalidate_chains",
]
