"""Checkpointing, the PyTorch twin of ``repro/training/checkpoint.py``: it
writes and reads the reference's container, so a checkpoint of either
package loads into the other.

The container is a msgpack payload ``{"metadata": {...}, "arrays": {path:
{"dtype", "shape", "data"}}}``, compressed with zstd when ``zstandard`` is
installed, else with zlib (level 6), as the reference falls back.  A path
is the leaf's keys joined by ``/`` (a named tuple's field is ``.name``, as
``jax.tree_util`` names it); ``data`` is the array's raw little-endian
bytes.  bfloat16 leaves carry the dtype
string ``"bfloat16"``, which numpy cannot parse without ``ml_dtypes``:
their bytes go through ``uint16``, as ``models/bridge.py`` hands them over.
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, Tuple

import msgpack
import numpy as np
import torch

try:
    import zstandard
except ImportError:                       # installations without zstd
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _items(tree, prefix=()):
    """(path tuple, leaf) pairs in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (f".{name}",))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> Tuple[str, np.ndarray]:
    """(dtype string, array of its bytes) of a tensor or a number."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
    elif isinstance(leaf, int):
        a = np.asarray(leaf, np.int32)     # a step count, as JAX keeps it
    else:
        a = np.asarray(leaf)
    return str(a.dtype), a


def _from_record(rec) -> torch.Tensor:
    if rec["dtype"] == "bfloat16":
        a = np.frombuffer(rec["data"], np.uint16).reshape(rec["shape"])
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(rec["data"], np.dtype(rec["dtype"]))
    return torch.from_numpy(a.reshape(rec["shape"]).copy())


def save(path: str, tree: Any, metadata: Dict[str, Any] | None = None) -> int:
    """Writes ``tree`` (nested dicts and named tuples of tensors or
    numbers) to ``path`` atomically; returns the compressed size."""
    arrays = {}
    for keys, leaf in _items(tree):
        dtype, a = _to_numpy(leaf)
        arrays["/".join(keys)] = {"dtype": dtype, "shape": list(a.shape),
                                  "data": a.tobytes()}
    raw = msgpack.packb({"metadata": metadata or {}, "arrays": arrays},
                        use_bin_type=True)
    if zstandard is not None:
        comp = zstandard.ZstdCompressor(level=3).compress(raw)
    else:
        comp = zlib.compress(raw, 6)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)
    return len(comp)


def _rebuild(like, flat, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], flat, prefix + (str(k),)) for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), flat,
                                     prefix + (f".{n}",))
                            for n in like._fields))
    t = flat["/".join(prefix)]
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return type(like)(t.item())


def load(path: str, like: Any | None = None) -> Tuple[Any, Dict[str, Any]]:
    """Returns (tree, metadata).  With ``like``, the tree takes its
    structure and each leaf its dtype and device; otherwise it is the flat
    path -> CPU tensor mapping."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise ImportError("checkpoint is zstd-compressed but the "
                              "zstandard module is unavailable")
        raw = zstandard.ZstdDecompressor().decompress(blob)
    else:
        raw = zlib.decompress(blob)
    payload = msgpack.unpackb(raw, raw=False)
    flat = {k: _from_record(v) for k, v in payload["arrays"].items()}
    if like is None:
        return flat, payload["metadata"]
    want = {"/".join(keys) for keys, _ in _items(like)}
    if want != set(flat):
        raise KeyError(f"checkpoint/tree key mismatch: missing "
                       f"{sorted(want - set(flat))[:5]}, unexpected "
                       f"{sorted(set(flat) - want)[:5]}")
    return _rebuild(like, flat), payload["metadata"]
