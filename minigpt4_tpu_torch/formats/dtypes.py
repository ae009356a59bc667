"""Data types for the minigpt4 / ggml model containers.

The reference engine enumerates 16 tensor data types shared between the
minigpt4 container and ggml (reference: minigpt4.h:30-48 and
the mapping functions at minigpt4.cpp:555-739).  We reproduce
the enum values exactly (they are serialized into model files) and attach the
block-quantization geometry each type implies.

All quantized types store weights as fixed-size blocks.  ``block_elems`` is the
number of logical float elements per block and ``block_bytes`` the packed size
of one block on disk.  These match ggml's layouts at llama.cpp master-31cfbb1
(the commit the reference pins in its CMakeLists.txt:318) with
QK_K = 256 super-blocks for the k-quants.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

QK = 32  # simple-quant block size
QK_K = 256  # k-quant super-block size


class DataType(enum.IntEnum):
    """Serialized dtype enum (minigpt4.h:30-48; convert.py DATA_TYPE)."""

    F16 = 0
    F32 = 1
    I32 = 2
    L64 = 3
    Q4_0 = 4
    Q4_1 = 5
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15


class GGMLType(enum.IntEnum):
    """ggml_type enum at llama.cpp master-31cfbb1 (ggml.h).

    This is the on-disk tensor type id used by llama.cpp model files; note the
    numbering differs from :class:`DataType` (ggml puts F32 first and has no
    Q4_2/Q4_3 anymore at that commit — their slots are reserved).
    """

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 removed (Q4_2 / Q4_3)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 16
    I16 = 17
    I32 = 18


@dataclass(frozen=True)
class TypeTraits:
    name: str
    block_elems: int
    block_bytes: int
    is_quantized: bool


_TRAITS: dict[DataType, TypeTraits] = {
    DataType.F16: TypeTraits("f16", 1, 2, False),
    DataType.F32: TypeTraits("f32", 1, 4, False),
    DataType.I32: TypeTraits("i32", 1, 4, False),
    DataType.L64: TypeTraits("l64", 1, 8, False),
    DataType.Q4_0: TypeTraits("q4_0", QK, 18, True),  # fp16 d + 16B nibbles
    DataType.Q4_1: TypeTraits("q4_1", QK, 20, True),  # fp16 d,m + 16B nibbles
    DataType.Q5_0: TypeTraits("q5_0", QK, 22, True),  # fp16 d + u32 qh + 16B
    DataType.Q5_1: TypeTraits("q5_1", QK, 24, True),  # fp16 d,m + u32 qh + 16B
    DataType.Q8_0: TypeTraits("q8_0", QK, 34, True),  # fp16 d + 32 int8
    DataType.Q8_1: TypeTraits("q8_1", QK, 40, True),  # fp32 d,s + 32 int8
    DataType.Q2_K: TypeTraits("q2_k", QK_K, 84, True),
    DataType.Q3_K: TypeTraits("q3_k", QK_K, 110, True),
    DataType.Q4_K: TypeTraits("q4_k", QK_K, 144, True),
    DataType.Q5_K: TypeTraits("q5_k", QK_K, 176, True),
    DataType.Q6_K: TypeTraits("q6_k", QK_K, 210, True),
    DataType.Q8_K: TypeTraits("q8_k", QK_K, 292, True),  # f32 d + 256 i8 + 16 i16
}

# DataType <-> GGMLType (both directions; mirrors the mapping behaviour of
# data_type_to_ggml_type / ggml_type_to_data_type, minigpt4.cpp:555-739).
_DATA_TO_GGML = {
    DataType.F16: GGMLType.F16,
    DataType.F32: GGMLType.F32,
    DataType.I32: GGMLType.I32,
    DataType.Q4_0: GGMLType.Q4_0,
    DataType.Q4_1: GGMLType.Q4_1,
    DataType.Q5_0: GGMLType.Q5_0,
    DataType.Q5_1: GGMLType.Q5_1,
    DataType.Q8_0: GGMLType.Q8_0,
    DataType.Q8_1: GGMLType.Q8_1,
    DataType.Q2_K: GGMLType.Q2_K,
    DataType.Q3_K: GGMLType.Q3_K,
    DataType.Q4_K: GGMLType.Q4_K,
    DataType.Q5_K: GGMLType.Q5_K,
    DataType.Q6_K: GGMLType.Q6_K,
    DataType.Q8_K: GGMLType.Q8_K,
}
_GGML_TO_DATA = {v: k for k, v in _DATA_TO_GGML.items()}


def traits(dtype: DataType) -> TypeTraits:
    return _TRAITS[DataType(dtype)]


def data_type_to_ggml(dtype: DataType) -> GGMLType:
    return _DATA_TO_GGML[DataType(dtype)]


def ggml_to_data_type(gtype: GGMLType) -> DataType:
    return _GGML_TO_DATA[GGMLType(gtype)]


def row_bytes(dtype: DataType, n_elems: int) -> int:
    """Packed size in bytes of ``n_elems`` elements of ``dtype``.

    ``n_elems`` must be a multiple of the block size for quantized types
    (ggml enforces the same invariant on row sizes).
    """
    t = traits(dtype)
    if n_elems % t.block_elems:
        raise ValueError(
            f"{t.name}: {n_elems} elements not divisible by block size {t.block_elems}"
        )
    return (n_elems // t.block_elems) * t.block_bytes


def is_quantized(dtype: DataType) -> bool:
    return traits(dtype).is_quantized
