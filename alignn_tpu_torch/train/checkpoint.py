"""Read and write the JAX package's ``.mpk`` checkpoints without flax.

flax writes checkpoints with ``msgpack``; neither package is a dependency
of the port (the card's host has no ``msgpack``), so this module carries a
pure-Python decoder and encoder for the subset flax uses: maps, arrays,
str, bin, int, float, nil and bool, plus flax's ext types 1 (ndarray: an
inner msgpack ``(shape, dtype-name, buffer)``) and 3 (numpy scalar, the
same payload).

- :func:`save_params` writes a weights file in the layout of
  ``alignn_tpu.train.checkpoint.save_params`` (``params``,
  ``batch_stats``, ``meta``), which alignn_tpu's loaders read;
  :func:`load_params_with_meta` reads the JAX package's files and the
  port's.
- :func:`save_train_state` / :func:`load_train_state` write and read the
  port's full training state (``restart.mpk``): weights, BatchNorm
  buffers, the torch optimizer's state, the step, the epoch and
  ``extra``.  Only the port reads it.
- :func:`convert_torch_checkpoint` reads a checkpoint of the reference
  implementation (a ``.pt`` state dict) into the JAX package's tree, and
  :func:`merge_converted` lays it over a model's own tree, reporting what
  it did not cover; :func:`save_converted_checkpoint` writes the result
  as a weights file.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from alignn_tpu_torch.chem.features import feature_table_provenance
from alignn_tpu_torch.nn.convert import flax_from_module, state_dict_from_flax

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


def _pack(obj: Any, out: list):
    """Append the msgpack encoding of `obj` to `out` with flax's choices:
    arrays and numpy scalars as ext types 1 and 3, str as str, map keys
    sorted."""
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        out.append(bytes([0xA0 | n]) if n < 32 else
                   struct.pack(">BB", 0xD9, n) if n < 1 << 8 else
                   struct.pack(">BH", 0xDA, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xDB, n))
        out.append(raw)
    elif isinstance(obj, bytes):
        n = len(obj)
        out.append(struct.pack(">BB", 0xC4, n) if n < 1 << 8 else
                   struct.pack(">BH", 0xC5, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xC6, n))
        out.append(obj)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)   # a 0-d array for a scalar
        inner: list = []
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], inner)
        payload = b"".join(inner)
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        n = len(payload)
        fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        out.append(struct.pack(">Bb", fix[n], code) if n in fix else
                   struct.pack(">BBb", 0xC7, n, code) if n < 1 << 8 else
                   struct.pack(">BHb", 0xC8, n, code) if n < 1 << 16 else
                   struct.pack(">BIb", 0xC9, n, code))
        out.append(payload)
    elif isinstance(obj, dict):
        n = len(obj)
        out.append(bytes([0x80 | n]) if n < 16 else
                   struct.pack(">BH", 0xDE, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xDF, n))
        for key in sorted(obj):   # flax's order
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(bytes([0x90 | n]) if n < 16 else
                   struct.pack(">BH", 0xDC, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xDD, n))
        for value in obj:
            _pack(value, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v >= 0:
        for fmt, code, top in ((">BB", 0xCC, 1 << 8), (">BH", 0xCD, 1 << 16),
                               (">BI", 0xCE, 1 << 32),
                               (">BQ", 0xCF, 1 << 64)):
            if v < top:
                return struct.pack(fmt, code, v)
    for fmt, code, bits in ((">Bb", 0xD0, 7), (">Bh", 0xD1, 15),
                            (">Bi", 0xD2, 31), (">Bq", 0xD3, 63)):
        if v >= -(1 << bits):
            return struct.pack(fmt, code, v)
    raise OverflowError(v)


def msgpack_serialize(tree: Any) -> bytes:
    """Encode nested dicts of arrays as flax's ``msgpack_serialize`` does."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def _write(path: str, payload: Dict[str, Any]):
    """Write under a temporary name, then publish with ``os.replace``: a
    run killed mid-write leaves the previous file whole."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, path)


def checkpoint_meta(atom_features: str = "cgcnn", **extra) -> Dict[str, Any]:
    """Checkpoint metadata: the feature table's provenance, plus extras."""
    meta = {"feature_table": feature_table_provenance(atom_features)}
    meta.update(extra)
    return meta


def save_params(path: str, params: Dict, batch_stats: Optional[Dict] = None,
                meta: Optional[Dict[str, Any]] = None):
    """Weights checkpoint in the JAX package's layout; `params` and
    `batch_stats` are flax trees (:func:`~alignn_tpu_torch.nn.convert.
    flax_from_module` gives them for a model)."""
    payload: Dict[str, Any] = {"params": params}
    if batch_stats:
        payload["batch_stats"] = batch_stats
    if meta:
        payload["meta"] = meta
    _write(path, payload)


def load_params_with_meta(path: str) -> Tuple[Dict, Dict, Dict[str, Any]]:
    """(params, batch_stats, meta) of a weights checkpoint."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return (payload["params"], payload.get("batch_stats", {}),
            payload.get("meta") or {})


def _optimizer_to_tree(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A torch optimizer state dict with str keys and numpy leaves; a
    group's device-tensor learning rate is written as its float."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, dict):
            return {str(k): conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v

    groups = [{k: float(v) if k == "lr" and isinstance(v, torch.Tensor)
               else v for k, v in g.items()} for g in sd["param_groups"]]
    return conv({**sd, "param_groups": groups})


def _optimizer_from_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`_optimizer_to_tree` (int state keys, tensors,
    tuple ``betas``)."""
    state = {int(k): {n: torch.from_numpy(np.array(v))
                      if isinstance(v, np.ndarray) else v
                      for n, v in entry.items()}
             for k, entry in tree["state"].items()}
    groups = [{k: tuple(v) if k == "betas" else v for k, v in g.items()}
              for g in tree["param_groups"]]
    return {"state": state, "param_groups": groups}


# how an optimizer runs, not what it learned: kept from the optimizer
# that loads a file (a CPU run's file resumes on the card and back)
_RUN_FLAGS = ("capturable", "fused", "foreach", "differentiable")


def _load_optimizer(optimizer: torch.optim.Optimizer,
                    sd: Dict[str, Any]) -> None:
    """Load `sd` into `optimizer`, which has taken no step yet: a captured
    train step reads the optimizer's state tensors, and
    ``load_state_dict`` replaces them.  Its own run flags and
    learning-rate tensors stay (each lr tensor takes the file's value in
    place)."""
    if optimizer.state:
        raise ValueError("load the training state before the first train "
                         "step: the optimizer already holds state")
    own = optimizer.param_groups
    saved = sd["param_groups"]
    if len(saved) != len(own):
        raise ValueError("the file's optimizer has another number of "
                         "parameter groups")
    lrs = [g["lr"] for g in own]
    optimizer.load_state_dict({**sd, "param_groups": [
        {**g, **{k: o[k] for k in _RUN_FLAGS if k in o}}
        for g, o in zip(saved, own)]})
    for g, lr, s in zip(optimizer.param_groups, lrs, saved):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(s["lr"]))
            g["lr"] = lr
        else:
            g["lr"] = float(s["lr"])


def save_train_state(path: str, state, epoch: int,
                     extra: Optional[Dict[str, Any]] = None):
    """The whole training state (``restart.mpk``): the model's params and
    BatchNorm buffers, the optimizer's state, the step, the epoch and
    `extra`."""
    params, stats = flax_from_module(state.model)
    _write(path, {
        "params": params, "batch_stats": stats,
        "opt_state": _optimizer_to_tree(state.optimizer.state_dict()),
        "step": int(state.step), "epoch": int(epoch), "extra": extra or {}})


def load_train_state(path: str, state, with_extra: bool = False):
    """Restore :func:`save_train_state`'s file into `state` (its model and
    optimizer, in place) before its first step; returns (state, epoch) or
    (state, epoch, extra)."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    state.model.load_state_dict(state_dict_from_flax(
        payload["params"], batch_stats=payload["batch_stats"]))
    _load_optimizer(state.optimizer,
                    _optimizer_from_tree(payload["opt_state"]))
    state.step = int(payload["step"])
    epoch = int(payload.get("epoch", 0))
    if with_extra:
        return state, epoch, payload.get("extra", {})
    return state, epoch


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


# ---------------------------------------------------------------------------
# reference-format .pt checkpoints (the reference's own state dicts)
# ---------------------------------------------------------------------------

_NORM_MAP = {"weight": "scale", "bias": "bias",
             "running_mean": "mean", "running_var": "var"}


def _convert_entries(sd: Dict[str, np.ndarray], layout: str = "nested"):
    """Yield (flax path tuple, collection, array) for each entry of a
    reference state dict that has a place in the JAX package's tree.

    The reference names (models/alignn.py, models/alignn_atomwise.py):
    ``atom_embedding.layer.{0: Linear, 1: Norm}.*`` (an MLPLayer),
    ``edge_embedding`` / ``angle_embedding`` Sequentials of an RBF (index
    0, no parameters) and two MLPLayers, ``alignn_layers.N.{node_update,
    edge_update}.<EGGC>`` and ``gcn_layers.N.<EGGC>`` with EGGC fields
    ``src_gate``, ``dst_gate``, ``edge_gate``, ``src_update``,
    ``dst_update``, ``bn_nodes``, ``bn_edges``; the heads ``fc``,
    ``fc1``..``fc3``, ``fc_atomwise``, ``fc_additional_output`` (``fc1``
    and ``fc2`` are MLPLayers in an extra-features model) and
    ``extra_feature_embedding``.  A DDP ``module.`` prefix is dropped.

    `layout` "nested" gives the ALIGNN / ALIGNNAtomWise tree
    (``embeddings/`` and ``trunk/``), "flat" eALIGNN's (everything at the
    top).  Unknown entries are skipped.
    """
    def mlp(dest, rest, arr):
        # rest: ['layer', '0', 'weight'] (Linear) or ['layer', '1', p]
        if len(rest) < 3 or rest[0] != "layer":
            return None
        idx, p = rest[1], rest[2]
        if idx == "0":
            if p == "weight":
                return dest + ("linear", "kernel"), "params", arr.T
            return dest + ("linear", "bias"), "params", arr
        if p in ("running_mean", "running_var"):
            return dest + ("norm", _NORM_MAP[p]), "batch_stats", arr
        if p == "num_batches_tracked":
            return None
        return dest + ("norm", _NORM_MAP[p]), "params", arr

    def eggc(dest, rest, arr):
        mod, p = rest[0], rest[-1]
        if mod in ("src_gate", "dst_gate", "edge_gate", "src_update",
                   "dst_update"):
            if p == "weight":
                return dest + (mod, "kernel"), "params", arr.T
            return dest + (mod, "bias"), "params", arr
        if mod in ("norm_nodes", "norm_edges", "bn_nodes", "bn_edges"):
            name = {"bn_nodes": "norm_nodes",
                    "bn_edges": "norm_edges"}.get(mod, mod)
            if p in ("running_mean", "running_var"):
                return dest + (name, _NORM_MAP[p]), "batch_stats", arr
            if p == "num_batches_tracked":
                return None
            return dest + (name, _NORM_MAP[p]), "params", arr
        return None

    emb = () if layout == "flat" else ("embeddings",)
    trunk = () if layout == "flat" else ("trunk",)
    for key, w in sd.items():
        parts = key.split(".")
        arr = np.asarray(w)
        if parts[0] == "module":
            parts = parts[1:]
        head = parts[0]
        out = None
        if head == "atom_embedding":
            out = mlp(emb + ("atom_embedding",), parts[1:], arr)
        elif head in ("edge_embedding", "angle_embedding"):
            if parts[1] != "0":      # index 0 is the RBF
                out = mlp(emb + (f"{head}_{int(parts[1]) - 1}",),
                          parts[2:], arr)
        elif head == "extra_feature_embedding":
            out = mlp(("extra_feature_embedding",), parts[1:], arr)
        elif head == "alignn_layers":
            out = eggc(trunk + (f"alignn_layers_{parts[1]}", parts[2]),
                       parts[3:], arr)
        elif head == "gcn_layers":
            out = eggc(trunk + (f"gcn_layers_{parts[1]}",), parts[2:], arr)
        elif head in ("fc", "fc1", "fc2", "fc3", "fc_atomwise",
                      "fc_additional_output"):
            if len(parts) >= 3 and parts[1] == "layer":
                out = mlp((head,), parts[1:], arr)
            else:
                p = parts[2] if len(parts) >= 3 and parts[1].isdigit() \
                    else parts[1]
                if p == "weight":
                    out = (head, "kernel"), "params", arr.T
                elif p == "bias":
                    # the reference's log-link init leaves a 0-d fc.bias
                    out = (head, "bias"), "params", np.atleast_1d(arr)
        if out is not None:
            yield out


def _unflatten(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    flat: Dict[Tuple[str, ...], Any] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flatten(value, prefix + (key,)))
        else:
            flat[prefix + (key,)] = value
    return flat


def convert_torch_checkpoint(pt_path: str, layout: str = "nested"
                             ) -> Tuple[Dict, Dict]:
    """A reference ``.pt`` checkpoint (a state dict, ``{"model": state
    dict}`` or a module) as the JAX package's (params, batch_stats)
    trees of numpy arrays; `layout` "nested" for ALIGNN / ALIGNNAtomWise,
    "flat" for eALIGNN."""
    obj = torch.load(pt_path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in sd.items()}
    flat: Dict[str, Dict[Tuple[str, ...], np.ndarray]] = {
        "params": {}, "batch_stats": {}}
    for path, coll, arr in _convert_entries(sd, layout=layout):
        flat[coll][path] = arr
    return _unflatten(flat["params"]), _unflatten(flat["batch_stats"])


def save_converted_checkpoint(pt_path: str, out_path: str,
                              atom_features: str = "cgcnn",
                              layout: str = "nested") -> str:
    """Convert a reference ``.pt`` checkpoint into a weights file stamped
    with the feature table it was converted against."""
    params, stats = convert_torch_checkpoint(pt_path, layout=layout)
    meta = checkpoint_meta(atom_features,
                           converted_from=os.path.basename(pt_path))
    save_params(out_path, params, stats or None, meta=meta)
    return out_path


def merge_converted(template: Dict, converted: Dict) -> Tuple[Dict, Dict]:
    """(tree, report): `template` with each leaf that `converted` holds at
    the same path and shape replaced (in the template leaf's dtype).
    ``report`` lists the template paths ``missing`` from the conversion
    (they keep their values), those ``mismatched`` in shape, and the
    converted paths ``unused``, each as "a/b/c"."""
    t, c = _flatten(template), _flatten(converted)
    missing, mismatched = [], []
    for k in t:
        if k not in c:
            missing.append("/".join(k))
        elif np.shape(c[k]) == np.shape(t[k]):
            t[k] = np.asarray(c[k], dtype=np.asarray(t[k]).dtype)
        else:
            mismatched.append("/".join(k))
    report = {"missing": missing, "mismatched": mismatched,
              "unused": ["/".join(k) for k in c if k not in t]}
    return _unflatten(t), report
