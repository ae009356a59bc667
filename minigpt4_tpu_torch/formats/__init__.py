"""Model file formats: the minigpt4 ggml-container, llama.cpp model files,
and the ggml block-quantization codecs."""

from .dtypes import QK, QK_K, DataType, GGMLType, row_bytes, traits, is_quantized
from .container import ContainerReader, ContainerWriter, SUBMODEL_NAMES, TensorRecord
from .ggml_llama import LlamaFileReader, LlamaFileWriter, LlamaHParams, LlamaVocab
from . import quants

__all__ = [
    "QK",
    "QK_K",
    "DataType",
    "GGMLType",
    "row_bytes",
    "traits",
    "is_quantized",
    "ContainerReader",
    "ContainerWriter",
    "SUBMODEL_NAMES",
    "TensorRecord",
    "LlamaFileReader",
    "LlamaFileWriter",
    "LlamaHParams",
    "LlamaVocab",
    "quants",
]
