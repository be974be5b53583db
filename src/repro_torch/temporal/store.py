"""`VersionedStore`: write/read delta-coded version sequences (v4 files),
as in ``repro.temporal.store``.

The writer keeps a float64 running reconstruction ``hat`` of the LAST
written version — exactly the sum every reader computes — so each
residual is fitted against what a decoder will actually see, not against
the raw previous tensor.  Residual error therefore cannot compound
silently: version k's chain fitness is measured against the true input
and ``rekey_below`` (optional) forces a fresh keyframe whenever a drifty
sequence degrades a chain below the gate.  Every ``append`` ends with a
``sync`` so the file on disk is always a valid, readable v4 container —
the checkpoint durability story.

NTTD keyframes and residuals are fitted on ``device`` (CUDA unless given)
through the training kernels, and every NTTD component decodes there; the
other codecs fit and decode on the host, as in the reference, and write
files byte-identical to its.

    with VersionedStore.create("run.tcdc", codec="nttd",
                               keyframe_interval=8) as store:
        for x in snapshots:
            stats = store.append(x)   # {"version", "keyframe", "bytes", ...}

    reader = VersionedStore.open("run.tcdc")      # or open(path, device="cpu")
    x5 = reader.decode(version=5)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.codecs import container
from repro_torch.codecs.base import Encoded, get_codec
from repro_torch.stream.writer import ChunkedWriter
from repro_torch.temporal.delta import ChainEncoded, DeltaFitter, resolve_chain


class VersionedStore:
    """Writer for a v4 delta container.  Use :meth:`create` / :meth:`open`."""

    def __init__(
        self,
        path: str,
        codec: str = "nttd",
        *,
        keyframe_interval: int = 8,
        chunk_bytes: int = 1 << 20,
        keyframe_opts: dict | None = None,
        delta_opts: dict | None = None,
        delta_passes: int = 2,
        slab_entries: int = 1 << 14,
        rekey_below: float | None = None,
        device=None,
    ):
        if keyframe_interval < 1:
            raise ValueError(f"keyframe_interval must be >= 1, got {keyframe_interval}")
        if chunk_bytes <= 0:
            raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
        self.path = path
        self.codec_name = codec
        self.codec = get_codec(codec)
        self.keyframe_interval = int(keyframe_interval)
        self.chunk_bytes = int(chunk_bytes)
        self.keyframe_opts = dict(keyframe_opts or {})
        self.delta_opts = dict(delta_opts or {})
        self.delta_passes = int(delta_passes)
        self.slab_entries = int(slab_entries)
        self.rekey_below = rekey_below
        #: where NTTD fits run (CUDA unless given); unused by host codecs
        self.device = device
        self._writer = ChunkedWriter(path, codec, delta=True)
        self._shape: tuple[int, ...] | None = None
        self._delta: DeltaFitter | None = None
        self._hat: np.ndarray | None = None  # f64 decode of the last version
        self._vid = 0

    @classmethod
    def create(cls, path: str, codec: str = "nttd", **kw) -> "VersionedStore":
        """Start a new versioned store at ``path`` (constructor alias,
        mirroring :meth:`open`)."""
        return cls(path, codec, **kw)

    @staticmethod
    def open(path: str, device=None) -> "VersionedReader":
        return VersionedReader(path, device=device)

    # -- writing -----------------------------------------------------------
    @property
    def n_versions(self) -> int:
        return self._vid

    def append(self, x: np.ndarray) -> dict:
        """Write tensor ``x`` as the next version; returns append stats."""
        x32 = np.asarray(x, np.float32)
        if self._shape is None:
            self._shape = tuple(x32.shape)
            self._delta = DeltaFitter(
                self._shape,
                self.codec_name,
                slab_entries=self.slab_entries,
                passes=self.delta_passes,
                opts=self.delta_opts,
                device=self.device,
            )
        elif tuple(x32.shape) != self._shape:
            raise ValueError(
                f"version {self._vid} shape {tuple(x32.shape)} != {self._shape}"
            )
        vid = self._vid
        keyframe = vid % self.keyframe_interval == 0
        rekeyed = False
        if not keyframe:
            residual = np.asarray(x32, np.float64) - self._hat
            enc = self._delta.fit_residual(residual.astype(np.float32))
            hat = self._hat + np.asarray(enc.to_dense(), np.float64)
            fit = _fitness(x32, hat)
            if self.rekey_below is not None and fit < self.rekey_below:
                keyframe = rekeyed = True  # chain degraded: cut a fresh keyframe
            else:
                nbytes = self._write_version(enc, base=vid - 1)
                self._hat = hat
        if keyframe:
            enc = self._fit_keyframe(x32)
            nbytes = self._write_version(enc, base=-1)
            self._hat = np.asarray(enc.to_dense(), np.float64)
            fit = _fitness(x32, self._hat)
        self._writer.sync()  # file on disk is valid after every append
        self._vid += 1
        obs.fit_event(
            "version_append",
            version=vid,
            keyframe=keyframe,
            rekeyed=rekeyed,
            bytes=nbytes,
            fitness=fit,
        )
        return {
            "version": vid,
            "keyframe": keyframe,
            "rekeyed": rekeyed,
            "bytes": nbytes,
            "fitness": fit,
        }

    def _fit_keyframe(self, x32: np.ndarray) -> Encoded:
        opts = dict(self.keyframe_opts)
        budget = opts.pop("budget", None)
        if self.codec_name == "nttd":
            opts["device"] = self.device
        return self.codec.fit(x32, budget, **opts)

    def _write_version(self, enc: Encoded, base: int) -> int:
        body = enc.to_bytes()
        n_entries = int(np.prod(self._shape))
        n_chunks = -(-len(body) // self.chunk_bytes)
        self._writer.begin_version(base)
        for i, off in enumerate(range(0, len(body), self.chunk_bytes)):
            lo = i * n_entries // n_chunks
            hi = (i + 1) * n_entries // n_chunks
            self._writer.append(
                body[off : off + self.chunk_bytes],
                entry_range=(lo, hi) if hi > lo else None,
            )
        return len(body)

    def close(self) -> int:
        return self._writer.close()

    def __enter__(self) -> "VersionedStore":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._writer.__exit__(exc_type, exc, tb)


def _fitness(x: np.ndarray, hat: np.ndarray) -> float:
    x64 = np.asarray(x, np.float64)
    err = float(np.linalg.norm(x64 - hat))
    return 1.0 - err / max(float(np.linalg.norm(x64)), 1e-30)


@dataclasses.dataclass
class ChainHealth:
    """One version's post-repair verdict from :func:`revalidate_chains`."""

    version: int
    #: keyframe-to-version decode chain (resolve_chain order)
    chain: list[int]
    #: every chunk CRC on the chain passed and the decode is finite
    ok: bool
    error: str | None = None
    #: chain fitness against caller-provided truth (None without truth)
    fitness: float | None = None


def revalidate_chains(
    path: str, truth: dict[int, np.ndarray] | None = None, device=None
) -> list[ChainHealth]:
    """Re-validate every version chain of a v4 delta file — the repair
    controller's post-repair step for versioned payloads.

    Repairing a keyframe's chunks changes bytes that EVERY dependent
    residual decodes through, so a byte restore is not done until each
    chain re-reads clean (chunk CRCs) and decodes to finite values.  Pass
    ``truth`` (version -> dense original tensor, any subset) to also
    re-measure chain fitness the way the writer's ``rekey_below`` gate
    did at append time.  NTTD components decode on ``device`` (CUDA unless
    given).
    """
    out: list[ChainHealth] = []
    with VersionedReader(path, device=device) as reader:
        for v in range(reader.n_versions):
            chain = resolve_chain(reader.versions, v)
            try:
                hat = reader.decode(v)
                if not np.all(np.isfinite(hat)):
                    raise ValueError(f"version {v}: non-finite chain decode")
            except ValueError as e:
                out.append(ChainHealth(v, chain, ok=False, error=str(e)))
                continue
            fit = None
            if truth is not None and v in truth:
                fit = _fitness(np.asarray(truth[v]), hat.astype(np.float64))
            out.append(ChainHealth(v, chain, ok=True, fitness=fit))
    return out


class VersionedReader:
    """Eager in-process reader for a v4 file (the serve layer has its own
    lazy path through ``CodecService.load_stream``).  Component payloads
    materialize once, on ``device`` for NTTD (CUDA unless given), and are
    shared by every chain that includes them."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.device = device
        self._oc = container.open_container(path)
        if not self._oc.is_versioned:
            self._oc.close()
            raise ValueError(f"{path}: not a v{container.DELTA_VERSION} delta container")
        self.codec_name = self._oc.codec
        self.codec = get_codec(self._oc.codec)
        self._components: dict[int, Encoded] = {}

    @property
    def versions(self) -> list[container.VersionEntry]:
        return list(self._oc.versions)

    @property
    def n_versions(self) -> int:
        return len(self._oc.versions)

    def version_bytes(self, version: int) -> int:
        ve = self._oc.versions[version]
        return sum(c.length for c in self._oc.chunks[ve.chunk_start : ve.chunk_stop])

    def component(self, version: int) -> Encoded:
        """The stand-alone decode component version ``version`` contributes
        (keyframe payload or delta residual), cached after first read."""
        if version not in self._components:
            ve = self._oc.versions[version]
            body = b"".join(
                container.read_chunk(self._oc.view, c)
                for c in self._oc.chunks[ve.chunk_start : ve.chunk_stop]
            )
            self._components[version] = self.codec.encoded_cls.from_bytes(
                body, device=self.device
            )
        return self._components[version]

    def encoded(self, version: int | None = None) -> ChainEncoded:
        v = self.n_versions - 1 if version is None else int(version)
        chain = resolve_chain(self._oc.versions, v)
        return ChainEncoded([self.component(c) for c in chain])

    def decode(self, version: int | None = None) -> np.ndarray:
        return self.encoded(version).to_dense()

    def decode_at(self, indices: np.ndarray, version: int | None = None) -> np.ndarray:
        return self.encoded(version).decode_at(indices)

    def close(self) -> None:
        self._components.clear()
        self._oc.close()

    def __enter__(self) -> "VersionedReader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
