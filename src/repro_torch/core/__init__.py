"""TensorCodec core of the port: NTTD, folding and reordering, the
competitor baselines, the codec (fitting by Alg. 1 and decode) and the v2
serializer.  The unified registry, ``repro_torch.codecs.get_codec``, is the
preferred entry point for fitting, querying and on-disk payloads."""
from repro_torch.core.codec import CodecConfig, CompressedTensor, CompressionLog, compress
from repro_torch.core.folding import FoldingSpec, make_folding_spec
from repro_torch.core.nttd import NTTDConfig

__all__ = [
    "CodecConfig",
    "CompressedTensor",
    "CompressionLog",
    "compress",
    "FoldingSpec",
    "make_folding_spec",
    "NTTDConfig",
]
