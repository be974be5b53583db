"""TensorCodec core of the port: NTTD, folding, the decode half of the
codec and the v2 serializer."""
from repro_torch.core.codec import CompressedTensor
from repro_torch.core.folding import FoldingSpec, make_folding_spec
from repro_torch.core.nttd import NTTDConfig

__all__ = ["CompressedTensor", "FoldingSpec", "make_folding_spec", "NTTDConfig"]
