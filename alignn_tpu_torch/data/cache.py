"""On-disk cache of built graphs (counterpart of ``alignn_tpu/data/cache.py``).

Graphs are built once, packed into compact binary blobs and appended to
a record store; training reads them back one at a time.  The files are
those of the JAX package's store (its C++ ``recordstore.cpp`` or its
pure-Python fallback), so a cache written by either package reads in the
other.  The port keeps the Python store only: reading a record's bytes
from the memory-mapped file is a small share of the read, and unpacking
the record, the same code behind either store, is the rest (PERF.md §5).

Blob format per record (no pickle): int32 n_arrays, then per array: int32
name length, the name, int8 dtype id, int8 ndim, int64 shape, raw data.
Files: ``<path>.data`` (blobs back to back) and ``<path>.idx`` (int64 n,
then n x (int64 offset, int64 length)).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

from alignn_tpu_torch.graph.build import GraphData

_DTYPES = {0: np.int32, 1: np.int64, 2: np.float32, 3: np.float64}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}

_FIELDS = ("z", "frac_coords", "lattice", "src", "dst", "r", "images",
           "lg_src", "lg_dst", "target", "atomwise_target", "forces",
           "stress", "additional", "extra_features")


def pack_graph(g: GraphData) -> bytes:
    arrays = {name: np.asarray(getattr(g, name)) for name in _FIELDS
              if getattr(g, name, None) is not None}
    arrays["volume"] = np.asarray([g.volume], dtype=np.float64)
    parts = [struct.pack("<i", len(arrays))]
    for name, arr in arrays.items():
        if arr.dtype not in _DTYPE_IDS:
            arr = arr.astype(np.float64)
        nb = name.encode()
        parts.append(struct.pack("<i", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<bb", _DTYPE_IDS[arr.dtype], arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        parts.append(np.ascontiguousarray(arr).tobytes())
    return b"".join(parts)


def unpack_graph(buf: bytes) -> GraphData:
    off = 0
    (n_arrays,) = struct.unpack_from("<i", buf, off)
    off += 4
    arrays = {}
    for _ in range(n_arrays):
        (nlen,) = struct.unpack_from("<i", buf, off)
        off += 4
        name = buf[off:off + nlen].decode()
        off += nlen
        dt, ndim = struct.unpack_from("<bb", buf, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        dtype = np.dtype(_DTYPES[dt])
        count = int(np.prod(shape)) if ndim else 1
        arrays[name] = np.frombuffer(buf, dtype=dtype, count=count,
                                     offset=off).reshape(shape).copy()
        off += count * dtype.itemsize
    vol = float(arrays.pop("volume")[0])
    return GraphData(volume=vol, **{k: arrays.get(k) for k in _FIELDS})


class GraphCacheWriter:
    """Streaming writer: graphs go to disk one at a time."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.data = open(path + ".data", "wb")
        self.offsets: List[int] = []
        self.lengths: List[int] = []
        self.pos = 0
        self.count = 0

    def put(self, g: GraphData):
        blob = pack_graph(g)
        self.data.write(blob)
        self.offsets.append(self.pos)
        self.lengths.append(len(blob))
        self.pos += len(blob)
        self.count += 1

    def close(self):
        if self.data.closed:
            return
        self.data.close()
        # the index last: a cache without it does not exist
        with open(self.path + ".idx", "wb") as f:
            f.write(struct.pack("<q", len(self.offsets)))
            f.write(np.asarray([self.offsets, self.lengths], dtype="<i8")
                    .T.tobytes())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GraphCache:
    """Write-once, read-many cache of graphs (the data file memory-mapped,
    one record unpacked per access)."""

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(path + ".idx") and \
            os.path.exists(path + ".data")

    def __init__(self, path: str):
        self.path = path
        with open(path + ".idx", "rb") as f:
            (self.n,) = struct.unpack("<q", f.read(8))
            self.index = np.frombuffer(f.read(), dtype="<i8").reshape(
                self.n, 2)
        # np.memmap refuses an empty file, and an empty split writes one
        if self.n == 0 or os.path.getsize(path + ".data") == 0:
            self.data = np.zeros(0, dtype=np.uint8)
        else:
            self.data = np.memmap(path + ".data", dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return self.n

    def record(self, i: int) -> bytes:
        """Record `i`'s packed bytes."""
        if not 0 <= i < self.n:
            raise IndexError(i)
        off, n = self.index[i]
        return bytes(self.data[off:off + n])

    def __getitem__(self, i: int) -> GraphData:
        return unpack_graph(self.record(i))

    def close(self):
        self.data = np.zeros(0, dtype=np.uint8)
