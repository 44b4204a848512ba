"""Minimal reader for the Torch7 binary serialization format.

The reference framework (wqzsscc/deep-go) ships its bundled mini-dataset as
per-move records written with ``torch.save`` (reference makedata.lua:554,
dataloader.lua:30-39). This module decodes that public, documented format.
It is the port's copy of ``tools/t7reader.py`` (the same decoder), read by
``deepgo_tpu_torch.tools.convert_torch_dataset``.

Only the subset of the format that those records use is implemented:
numbers, strings, booleans, tables, and Byte/Double tensors + storages.
Format layout (little-endian):
  object := int32 type_tag, payload
    1 = number   -> float64
    2 = string   -> int32 length, bytes
    3 = table    -> int32 ref-index, int32 npairs, npairs * (key obj, val obj)
    4 = torch    -> int32 ref-index, string version ("V 1"), string classname,
                    class payload
    5 = boolean  -> int32
  Tensor payload  := int32 ndim, int64 sizes[nd], int64 strides[nd],
                     int64 storage_offset (1-based), object storage
  Storage payload := int64 numel, raw element data
Previously-seen ref-indices dereference to the memoized object.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_STORAGE_DTYPES = {
    "torch.ByteStorage": np.uint8,
    "torch.CharStorage": np.int8,
    "torch.ShortStorage": np.int16,
    "torch.IntStorage": np.int32,
    "torch.LongStorage": np.int64,
    "torch.FloatStorage": np.float32,
    "torch.DoubleStorage": np.float64,
}

_TENSOR_TO_STORAGE = {
    "torch.ByteTensor": "torch.ByteStorage",
    "torch.CharTensor": "torch.CharStorage",
    "torch.ShortTensor": "torch.ShortStorage",
    "torch.IntTensor": "torch.IntStorage",
    "torch.LongTensor": "torch.LongStorage",
    "torch.FloatTensor": "torch.FloatStorage",
    "torch.DoubleTensor": "torch.DoubleStorage",
}


@dataclass
class _Tensor:
    sizes: tuple
    strides: tuple
    offset: int  # 0-based element offset into storage
    storage: np.ndarray
    dtype: np.dtype

    def to_numpy(self) -> np.ndarray:
        if self.storage is None or not self.sizes:
            return np.zeros(self.sizes, dtype=self.dtype)
        return np.lib.stride_tricks.as_strided(
            self.storage[self.offset:],
            shape=self.sizes,
            strides=tuple(s * self.storage.itemsize for s in self.strides),
        ).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.memo: dict[int, object] = {}

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        out = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return out[0]

    def read_int(self) -> int:
        return self._unpack("<i")

    def read_long(self) -> int:
        return self._unpack("<q")

    def read_double(self) -> float:
        return self._unpack("<d")

    def read_bytes(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_string(self) -> str:
        n = self.read_int()
        return self.read_bytes(n).decode("latin-1")

    def read_object(self):
        tag = self.read_int()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            x = self.read_double()
            return int(x) if x == int(x) else x
        if tag == TYPE_STRING:
            return self.read_string()
        if tag == TYPE_BOOLEAN:
            return bool(self.read_int())
        if tag == TYPE_TABLE:
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            table: dict = {}
            self.memo[index] = table
            npairs = self.read_int()
            for _ in range(npairs):
                key = self.read_object()
                table[key] = self.read_object()
            return table
        if tag == TYPE_TORCH:
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            version = self.read_string()
            if version.startswith("V "):
                classname = self.read_string()
            else:
                classname = version  # pre-versioning files
            obj = self._read_torch_payload(classname)
            self.memo[index] = obj
            return obj
        raise ValueError(f"unknown torch type tag {tag} at offset {self.pos - 4}")

    def _read_torch_payload(self, classname: str):
        if classname in _TENSOR_TO_STORAGE:
            ndim = self.read_int()
            sizes = tuple(self.read_long() for _ in range(ndim))
            strides = tuple(self.read_long() for _ in range(ndim))
            offset = self.read_long() - 1
            storage = self.read_object()
            dtype = np.dtype(_STORAGE_DTYPES[_TENSOR_TO_STORAGE[classname]])
            tensor = _Tensor(sizes, strides, offset, storage, dtype)
            return tensor.to_numpy()
        if classname in _STORAGE_DTYPES:
            dtype = np.dtype(_STORAGE_DTYPES[classname])
            numel = self.read_long()
            raw = self.read_bytes(numel * dtype.itemsize)
            return np.frombuffer(raw, dtype=dtype)
        raise ValueError(f"unsupported torch class {classname!r}")


def load(path: str):
    """Load a torch.save()-produced file into Python/NumPy objects."""
    with open(path, "rb") as f:
        return _Reader(f.read()).read_object()
