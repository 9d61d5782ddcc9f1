from .constants import GGMLType, GGUFValueType, tensor_nbytes
from .quants import dequantize, dequantize_tensor
from .reader import GGUFReader, TensorInfo

__all__ = [
    "GGMLType",
    "GGUFValueType",
    "GGUFReader",
    "TensorInfo",
    "dequantize",
    "dequantize_tensor",
    "tensor_nbytes",
]
