"""Codec API of the port: protocol, registry and container, for the six
codecs the reference registers.

    from repro_torch.codecs import available, load_bytes

    enc = load_bytes(blob)            # on CUDA; load_bytes(blob, device="cpu")
    enc.decode_at(idx)                # entries at ORIGINAL indices
    enc.to_dense()
    available()                       # the reference's six ids

Modules: ``base`` (protocol + registry), ``adapters`` (the six wrappers,
imported here so they self-register), ``container`` (on-disk format).
"""
from repro_torch.codecs.base import Codec, Encoded, available, get_codec, register
from repro_torch.codecs import adapters  # noqa: F401  (self-registers the codecs)
from repro_torch.codecs.container import load_bytes, load_file, save_bytes, save_file

__all__ = [
    "Codec",
    "Encoded",
    "available",
    "get_codec",
    "register",
    "load_bytes",
    "load_file",
    "save_bytes",
    "save_file",
]
