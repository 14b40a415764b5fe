"""Weights for both sides: a committed potential decoded from its ``.mpk``
file, and one set of tensors copied into the program's model.

The decoder is a frozen copy of the subset of msgpack that flax writes
(maps, arrays, str, bin, int, float, nil, bool; ext 1, an ndarray, and
ext 3, a numpy scalar), so that the benchmark reads the file without the
program.  A flax tree maps onto the program's state-dict names
mechanically: dots join the path, a Dense ``kernel`` [in, out] becomes a
``weight`` [out, in], a norm's ``scale`` its ``weight``.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Dict

import numpy as np
import torch


class _Reader:
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
            return {self.value(): self.value() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
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
                return [self.value() for _ in range(n)]
            if kind == "map":
                return {self.value(): self.value() for _ in range(n)}
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

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == 1 else arr[()]


def load_potential(path: str, sha256: str) -> Dict[str, np.ndarray]:
    """{state-dict name: f32 array} of a flax weights file whose sha256
    must equal `sha256` (a changed file is another potential)."""
    with open(path, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    if digest != sha256:
        raise ValueError(f"{path}: sha256 {digest}, expected {sha256}")
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack payload")
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                key, arr = "weight", arr.T
            elif key == "scale":
                key = "weight"
            out[prefix + key] = np.ascontiguousarray(arr)

    walk(tree["params"], "")
    return out


def to_device(params: Dict[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in params.items()}


def load_into(module: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """Copy `params` into `module`'s parameters of the same names; every
    parameter must be covered, and every given tensor used."""
    named = dict(module.named_parameters())
    missing = sorted(set(named) - set(params))
    extra = sorted(set(params) - set(named))
    if missing or extra:
        raise ValueError(f"weights do not fit the model: missing {missing}"
                         f", unused {extra}")
    with torch.no_grad():
        for name, p in named.items():
            src = params[name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} for "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
