"""TensorCodec's own compression configs (paper §V), as in
``repro.configs.tensorcodec_paper``: the (R, h) presets the benchmarks and
the codec's smoke run use, on the port's ``CodecConfig`` (whose
``kernel_impl`` defaults to the kernels on the card)."""
from repro_torch.core.codec import CodecConfig

SMALL = CodecConfig(rank=6, hidden=12, epochs=120, batch_size=4096, lr=1e-2)
MEDIUM = CodecConfig(rank=10, hidden=18, epochs=200, batch_size=8192, lr=1e-2)
CONFIG = MEDIUM
SMOKE = SMALL
