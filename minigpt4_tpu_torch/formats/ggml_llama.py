"""Reader/writer for llama.cpp LLaMA model files (the Vicuna weights).

The reference delegates all LLM loading to ``llama_load_model_from_file`` from
llama.cpp pinned at master-31cfbb1 (the reference's CMakeLists.txt:318,
call site the reference's minigpt4.cpp:1783).  This module reimplements that
file format natively so existing ggml-vicuna ``.bin`` checkpoints load
unmodified (BASELINE.md checkpoint-compatibility contract).

Supported on-disk versions (llama.cpp ``llama_file_version``):

    'ggml'           unversioned legacy (no vocab scores, unaligned data)
    'ggmf' v1        scored vocab, unaligned data
    'ggjt' v1..v3    scored vocab, 32-byte aligned, mmap-able

Quantized tensors are only accepted from ggjt v3 files (earlier versions use
pre-May-2023 quant block layouts that llama.cpp itself refuses to load mixed);
f16/f32 tensors load from any version.

Layout of a ggjt file:

    uint32 magic ('ggjt'), uint32 version
    hparams: uint32 n_vocab, n_embd, n_mult, n_head, n_layer, n_rot, ftype
    n_vocab x { uint32 len; utf-8 bytes; float32 score }
    until EOF: { uint32 n_dims, uint32 name_len, uint32 ggml_type;
                 uint32 ne[n_dims]; name; pad to 32B; payload }
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import quants
from .dtypes import DataType, GGMLType, ggml_to_data_type, row_bytes

MAGIC_GGML = 0x67676D6C  # 'ggml' legacy, no version field
MAGIC_GGMF = 0x67676D66  # 'ggmf'
MAGIC_GGJT = 0x67676A74  # 'ggjt'

_NUMPY_OF = {
    DataType.F16: np.dtype("<f2"),
    DataType.F32: np.dtype("<f4"),
    DataType.I32: np.dtype("<i4"),
}


@dataclass
class LlamaHParams:
    n_vocab: int
    n_embd: int
    n_mult: int
    n_head: int
    n_layer: int
    n_rot: int
    ftype: int

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_ff(self) -> int:
        """Feed-forward width, derived exactly as llama.cpp does."""
        return ((2 * (4 * self.n_embd) // 3 + self.n_mult - 1) // self.n_mult) * self.n_mult


@dataclass
class LlamaTensorRecord:
    name: str
    shape: tuple[int, ...]  # numpy order (reversed ggml ne)
    dtype: DataType
    offset: int
    nbytes: int

    @property
    def n_elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclass
class LlamaVocab:
    tokens: list[bytes] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)


class LlamaFileReader:
    """mmap-backed reader for llama.cpp model files."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self.file_version: tuple[int, int] = (0, 0)  # (magic, version)
        self.hparams: LlamaHParams | None = None
        self.vocab = LlamaVocab()
        self.tensors: dict[str, LlamaTensorRecord] = {}
        self._parse()

    def _read(self, n: int) -> bytes:
        b = self._mm[self._pos : self._pos + n]
        if len(b) != n:
            raise EOFError(f"short read at {self._pos} ({self.path})")
        self._pos += n
        return b

    def _u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def _f32(self) -> float:
        return struct.unpack("<f", self._read(4))[0]

    def _parse(self) -> None:
        magic = self._u32()
        if magic == MAGIC_GGML:
            self.file_version = (magic, 0)
        elif magic in (MAGIC_GGMF, MAGIC_GGJT):
            version = self._u32()
            ok = {MAGIC_GGMF: (1,), MAGIC_GGJT: (1, 2, 3)}[magic]
            if version not in ok:
                raise ValueError(f"{self.path}: unsupported {magic:#x} version {version}")
            self.file_version = (magic, version)
        else:
            raise ValueError(f"{self.path}: unknown magic {magic:#x}")

        self.hparams = LlamaHParams(
            n_vocab=self._u32(),
            n_embd=self._u32(),
            n_mult=self._u32(),
            n_head=self._u32(),
            n_layer=self._u32(),
            n_rot=self._u32(),
            ftype=self._u32(),
        )

        has_scores = magic != MAGIC_GGML
        for _ in range(self.hparams.n_vocab):
            n = self._u32()
            self.vocab.tokens.append(self._read(n))
            self.vocab.scores.append(self._f32() if has_scores else 0.0)

        aligned = magic == MAGIC_GGJT
        quant_ok = self.file_version == (MAGIC_GGJT, 3)
        end = len(self._mm)
        while self._pos < end:
            n_dims = self._u32()
            name_len = self._u32()
            gtype = GGMLType(self._u32())
            ne = struct.unpack(f"<{n_dims}I", self._read(4 * n_dims))
            name = self._read(name_len).decode("utf-8")
            if aligned:
                self._pos = (self._pos + 31) & ~31
            dtype = ggml_to_data_type(gtype)
            from .dtypes import is_quantized

            if is_quantized(dtype) and not quant_ok:
                raise ValueError(
                    f"{self.path}: quantized tensor {name} in pre-ggjt-v3 file is unsupported"
                )
            shape = tuple(reversed([int(x) for x in ne]))
            nbytes = row_bytes(dtype, int(np.prod(shape)))
            if self._pos + nbytes > end:
                raise EOFError(
                    f"{self.path}: tensor {name} payload runs past EOF "
                    f"({self._pos}+{nbytes} > {end}) — truncated file"
                )
            self.tensors[name] = LlamaTensorRecord(name, shape, dtype, self._pos, nbytes)
            self._pos += nbytes

    # -- tensor access --
    def raw(self, name: str) -> np.ndarray:
        rec = self.tensors[name]
        return np.frombuffer(self._mm, np.uint8, rec.nbytes, rec.offset)

    def tensor(self, name: str) -> np.ndarray:
        rec = self.tensors[name]
        raw = self.raw(name)
        npdt = _NUMPY_OF.get(rec.dtype)
        if npdt is not None:
            return raw.view(npdt).reshape(rec.shape)
        return quants.dequantize(raw, rec.dtype).reshape(rec.shape)

    def tensor_f32(self, name: str) -> np.ndarray:
        t = self.tensor(name)
        return t.astype(np.float32) if t.dtype != np.float32 else t

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            pass  # exported zero-copy views keep the pages mapped
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LlamaFileWriter:
    """Writes ggjt-v3 files (for tests, converters, and the quantizer)."""

    def __init__(self, path: str | Path, hparams: LlamaHParams, vocab: LlamaVocab):
        self.path = Path(path)
        self.hparams = hparams
        self.vocab = vocab
        self._tensors: list[tuple[str, tuple[int, ...], DataType, np.ndarray]] = []

    def add_tensor(
        self, name: str, shape: tuple[int, ...], dtype: DataType, raw: np.ndarray
    ) -> None:
        self._tensors.append((name, shape, DataType(dtype), np.ascontiguousarray(raw, np.uint8)))

    def write(self) -> None:
        from .dtypes import data_type_to_ggml

        hp = self.hparams
        with open(self.path, "wb") as f:
            f.write(struct.pack("<II", MAGIC_GGJT, 3))
            f.write(
                struct.pack(
                    "<7I", hp.n_vocab, hp.n_embd, hp.n_mult, hp.n_head, hp.n_layer, hp.n_rot, hp.ftype
                )
            )
            for tok, score in zip(self.vocab.tokens, self.vocab.scores):
                f.write(struct.pack("<I", len(tok)))
                f.write(tok)
                f.write(struct.pack("<f", score))
            for name, shape, dtype, raw in self._tensors:
                nb = name.encode("utf-8")
                ggml_ne = tuple(reversed(shape))
                f.write(struct.pack("<III", len(ggml_ne), len(nb), int(data_type_to_ggml(dtype))))
                f.write(struct.pack(f"<{len(ggml_ne)}I", *ggml_ne))
                f.write(nb)
                pad = (-f.tell()) & 31
                f.write(b"\x00" * pad)
                expect = row_bytes(dtype, int(np.prod(shape)))
                if raw.nbytes != expect:
                    raise ValueError(f"{name}: payload {raw.nbytes} != {expect}")
                f.write(raw.tobytes())
