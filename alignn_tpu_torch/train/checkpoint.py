"""Read the JAX package's ``.mpk`` weight checkpoints without flax.

flax writes checkpoints with ``msgpack``; neither package is a dependency
of the port, so this module carries a pure-Python decoder for the subset
flax uses: maps, arrays, str, bin, int, float, nil and bool, plus flax's
ext types 1 (ndarray: an inner msgpack ``(shape, dtype-name, buffer)``)
and 3 (numpy scalar, the same payload).
"""

from __future__ import annotations

import struct
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np

from alignn_tpu_torch.chem.features import feature_table_provenance

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Sequential decoder over one msgpack byte string."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                 0xC6: (">I", "bin"), 0xD9: (">B", "str"),
                 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"),
                 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        arr = _ndarray_from_bytes(payload)
        return arr if code == _EXT_NDARRAY else arr[()]


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(payload).value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """Decode a flax ``msgpack_serialize`` payload into nested dicts."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack payload")
    return tree


def load_params_with_meta(path: str) -> Tuple[Dict, Dict, Dict[str, Any]]:
    """(params, batch_stats, meta) of a weights checkpoint."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return (payload["params"], payload.get("batch_stats", {}),
            payload.get("meta") or {})


def check_feature_table(meta: Optional[Dict[str, Any]],
                        atom_features: str = "cgcnn",
                        where: str = "checkpoint") -> bool:
    """Warn when a checkpoint's stamped feature table is not the active one.

    True when provably matching; unstamped checkpoints return False.
    """
    stamped = (meta or {}).get("feature_table")
    if not stamped:
        return False
    active = feature_table_provenance(
        stamped.get("atom_features", atom_features))
    if stamped.get("sha256") != active["sha256"]:
        warnings.warn(
            f"{where} was saved against feature table sha256="
            f"{str(stamped.get('sha256'))[:12]}... but the active "
            f"{active['atom_features']} table is {active['sha256'][:12]}...:"
            f" embeddings will see different inputs", stacklevel=2)
        return False
    return True
