"""Reader/writer for the minigpt4 ggml-container model file.

Byte layout (established by the reference converter minigpt4/convert.py:146-180
and parsed by MiniGPT4ModelLoader, minigpt4.cpp:1475-1731):

    magic    b"ggml"                       (4 bytes, no length prefix)
    version  int32 little-endian           (1 == V0)
    ftype    int32                         (0 == F16, 1 == F32)
    config   int32 length + UTF-8 JSON     (embedded Q-Former hyperparams)
    5 sub-models, each:
        name        int32 length + UTF-8
        n_tensors   int32
        n_tensors x tensor header:
            name    int32 length + UTF-8
            n_dims  int32
            shape   int32 x n_dims         (ggml order: reversed numpy shape)
            dtype   int32                  (DataType enum)
        n_tensors x payload:
            seek to next 4096-byte page boundary (only if misaligned)
            raw packed tensor bytes (row-major over the *numpy* shape)

The reader memory-maps the file and returns zero-copy views of the payloads
(the loaders copy them onto the device); the writer produces byte-
identical structure so quantize round-trips (reference ``dump()``,
minigpt4.cpp:1632-1717) are reproducible.
"""

from __future__ import annotations

import json
import mmap
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .dtypes import DataType, row_bytes, traits
from . import quants

MAGIC = b"ggml"
FILE_VERSION_V0 = 1
PAGE_SIZE = 4096

SUBMODEL_NAMES = ("visual_encoder", "ln_vision", "query_tokens", "Qformer", "llama_proj")

_NUMPY_OF = {
    DataType.F16: np.dtype("<f2"),
    DataType.F32: np.dtype("<f4"),
    DataType.I32: np.dtype("<i4"),
    DataType.L64: np.dtype("<i8"),
}


def _align_page(pos: int) -> int:
    """Next page boundary, or ``pos`` itself if already aligned
    (convert.py:20-25 / MMapReader::seek_to_alignment)."""
    if pos & (PAGE_SIZE - 1):
        return (pos + PAGE_SIZE) & ~(PAGE_SIZE - 1)
    return pos


@dataclass
class TensorRecord:
    """One tensor in the container: header info + location of its payload."""

    name: str
    shape: tuple[int, ...]  # numpy order (outermost first)
    dtype: DataType
    offset: int = 0  # absolute file offset of payload
    nbytes: int = 0

    @property
    def n_elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclass
class SubModel:
    name: str
    tensors: dict[str, TensorRecord] = field(default_factory=dict)


class ContainerReader:
    """mmap-backed zero-copy container reader (L1/L3 of the reference)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            # advise the kernel we will read it all (MMappedFile MADV_WILLNEED,
            # minigpt4.cpp:318-425)
            self._mm.madvise(mmap.MADV_WILLNEED)
        except (AttributeError, OSError):
            pass
        self._pos = 0
        self.version: int = 0
        self.ftype: int = 0
        self.config: dict = {}
        self.models: dict[str, SubModel] = {}
        self._parse()

    # -- cursor reads (MMapReader, minigpt4.cpp:427-514) --
    def _read(self, n: int) -> bytes:
        b = self._mm[self._pos : self._pos + n]
        if len(b) != n:
            raise EOFError(f"short read at {self._pos} ({self.path})")
        self._pos += n
        return b

    def _read_i32(self) -> int:
        return struct.unpack("<i", self._read(4))[0]

    def _read_string(self) -> str:
        n = self._read_i32()
        return self._read(n).decode("utf-8")

    def _parse(self) -> None:
        if self._read(4) != MAGIC:
            from ..utils import MiniGPT4Error, MiniGPT4TypedError

            raise MiniGPT4TypedError(
                MiniGPT4Error.LOAD_MODEL_FILE_HEADER,
                f"{self.path}: bad magic (expected 'ggml')",
            )
        self.version = self._read_i32()
        if self.version != FILE_VERSION_V0:
            from ..utils import MiniGPT4Error, MiniGPT4TypedError

            raise MiniGPT4TypedError(
                MiniGPT4Error.LOAD_MODEL_FILE_VERSION,
                f"{self.path}: unsupported file version {self.version}",
            )
        self.ftype = self._read_i32()
        self.config = json.loads(self._read_string())
        for _ in range(len(SUBMODEL_NAMES)):
            self._parse_submodel()
        unknown = set(self.models) - set(SUBMODEL_NAMES)
        if unknown:
            raise ValueError(f"{self.path}: unexpected sub-models {unknown}")

    def _parse_submodel(self) -> None:
        name = self._read_string()
        n_tensors = self._read_i32()
        sm = SubModel(name)
        order: list[TensorRecord] = []
        for _ in range(n_tensors):
            tname = self._read_string()
            ndims = self._read_i32()
            ggml_shape = struct.unpack(f"<{ndims}i", self._read(4 * ndims))
            dtype = DataType(self._read_i32())
            rec = TensorRecord(tname, tuple(reversed(ggml_shape)), dtype)
            sm.tensors[tname] = rec
            order.append(rec)
        for rec in order:
            self._pos = _align_page(self._pos)
            rec.offset = self._pos
            rec.nbytes = row_bytes(rec.dtype, rec.n_elems)
            self._pos += rec.nbytes
        self.models[name] = sm

    # -- tensor access --
    def raw(self, model: str, name: str) -> np.ndarray:
        """Zero-copy uint8 view of the packed payload."""
        rec = self.models[model].tensors[name]
        return np.frombuffer(self._mm, np.uint8, rec.nbytes, rec.offset)

    def tensor(self, model: str, name: str) -> np.ndarray:
        """Decode to a typed numpy array (f16 stays f16; quants -> f32)."""
        rec = self.models[model].tensors[name]
        raw = self.raw(model, name)
        npdt = _NUMPY_OF.get(rec.dtype)
        if npdt is not None:
            return raw.view(npdt).reshape(rec.shape)
        return quants.dequantize(raw, rec.dtype).reshape(rec.shape)

    def tensor_f32(self, model: str, name: str) -> np.ndarray:
        t = self.tensor(model, name)
        return t.astype(np.float32) if t.dtype != np.float32 else t

    def model_type(self) -> str:
        """'7B' or '13B' from the llama_proj output width
        (MiniGPT4ModelLoader::get_model_type, minigpt4.cpp:1719-1731)."""
        rec = self.models["llama_proj"].tensors["weight"]
        out_dim = rec.shape[0]
        if out_dim == 4096:
            return "7B"
        if out_dim == 5120:
            return "13B"
        raise ValueError(f"unrecognized llama_proj width {out_dim}")

    def close(self) -> None:
        """Release the mapping.  Zero-copy views handed out by :meth:`raw`/
        :meth:`tensor` may still reference the map (e.g. aliased into CPU
        tensors); in that case the mapping stays alive until they are GC'd —
        the same lifetime model as the reference's mmap-backed weights."""
        try:
            self._mm.close()
        except BufferError:
            pass  # exported views keep the pages mapped
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ContainerWriter:
    """Serializes sub-models back into the container format (``dump()``
    equivalent, used by the quantizer)."""

    def __init__(self, path: str | Path, ftype: int, config: dict):
        self.path = Path(path)
        self.ftype = ftype
        self.config = config
        self._models: list[tuple[str, list[tuple[str, tuple[int, ...], DataType, np.ndarray]]]] = []

    def add_model(
        self, name: str, tensors: list[tuple[str, tuple[int, ...], DataType, np.ndarray]]
    ) -> None:
        """tensors: (name, numpy_shape, dtype, packed_bytes_uint8)."""
        self._models.append((name, tensors))

    def write(self) -> None:
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<i", FILE_VERSION_V0))
            f.write(struct.pack("<i", self.ftype))
            cfg = json.dumps(self.config).encode("utf-8")
            f.write(struct.pack("<i", len(cfg)))
            f.write(cfg)
            for name, tensors in self._models:
                nb = name.encode("utf-8")
                f.write(struct.pack("<i", len(nb)))
                f.write(nb)
                f.write(struct.pack("<i", len(tensors)))
                for tname, shape, dtype, _raw in tensors:
                    tb = tname.encode("utf-8")
                    f.write(struct.pack("<i", len(tb)))
                    f.write(tb)
                    ggml_shape = tuple(reversed(shape))
                    f.write(struct.pack("<i", len(ggml_shape)))
                    f.write(struct.pack(f"<{len(ggml_shape)}i", *ggml_shape))
                    f.write(struct.pack("<i", int(dtype)))
                for tname, shape, dtype, raw in tensors:
                    pos = f.tell()
                    aligned = _align_page(pos)
                    if aligned != pos:
                        f.write(b"\x00" * (aligned - pos))
                    expect = row_bytes(dtype, int(np.prod(shape)) if shape else 1)
                    raw = np.ascontiguousarray(raw, np.uint8)
                    if raw.nbytes != expect:
                        raise ValueError(
                            f"{name}.{tname}: payload {raw.nbytes} B != expected {expect} B"
                        )
                    f.write(raw.tobytes())
