"""Checkpointing — the port of ``repro/checkpoint/checkpoint.py``: save and
restore trees of tensors (parameters, optimizer state) as a flat ``.npz``
plus a JSON manifest, in the reference's format, so that f32 checkpoints
cross between the two packages both ways.

  * ``path.npz`` holds one array per leaf, keyed by the ``/``-joined dict
    keys and list indices from the root (``params/stack/0/0/mixer/wq``,
    ``opt/m/embed/table``), dict keys in sorted order;
  * ``path.json`` holds ``step``, ``keys`` and ``sha256`` (of the
    ``.npz``; the reference's ``treedef`` string, which no reader uses,
    is left out).  numpy has no bfloat16, so a bf16
    leaf is stored as its 16-bit pattern (``uint16``) and named in the
    manifest's extra key ``bfloat16``, which the reference's reader
    ignores; :func:`load_tensors` and :func:`restore` give it back bit
    for bit.

Crash-safe: both files are written to ``mkstemp`` siblings and
``os.replace``-d into place, so a kill mid-write leaves the previous
checkpoint or none, never a truncated file.  The payload's sha256 is
checked BEFORE anything is deserialized: a torn or corrupt payload raises
``ValueError``.  Manifests without a ``sha256`` key load unverified.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_map_with_path

BF16_KEY = "bfloat16"


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_paths(tree) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}

    def one(path, leaf):
        flat[_key(path)] = leaf
        return leaf

    tree_map_with_path(one, tree)
    return flat


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _atomic_bytes(path: str, write_fn) -> str:
    """Write via a temp sibling + ``os.replace`` (atomic on POSIX within a
    filesystem); returns the sha256 of the written bytes."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        digest = _sha256_file(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return digest


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(host array, whether it holds bf16 bits)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), False
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def save(path: str, tree, step: Optional[int] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    bf16 = []
    for k, v in _flatten_with_paths(tree).items():
        arrays[k], is_bf16 = _to_numpy(v)
        if is_bf16:
            bf16.append(k)
    # np.savez appends ".npz" to bare paths but honours open file handles,
    # which is what lets the payload go through the atomic temp file
    digest = _atomic_bytes(path + ".npz", lambda f: np.savez(f, **arrays))
    manifest = {"step": step, "keys": sorted(arrays), "sha256": digest}
    if bf16:
        manifest[BF16_KEY] = sorted(bf16)
    _atomic_bytes(path + ".json",
                  lambda f: f.write(json.dumps(manifest).encode()))


def verify(path: str) -> Dict[str, Any]:
    """Check the ``.npz`` payload against the manifest's sha256; returns
    the manifest.  Raises ``ValueError`` on a mismatch (truncated or
    corrupt checkpoint) BEFORE anything is deserialized."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    want = manifest.get("sha256")
    if want is not None:
        got = _sha256_file(path + ".npz")
        if got != want:
            raise ValueError(
                f"checkpoint {path!r} is truncated or corrupt: payload "
                f"sha256 {got[:16]}… does not match the manifest's "
                f"{want[:16]}… — restore refused (a kill mid-write, torn "
                f"rename, or on-disk corruption)")
    return manifest


def load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Checksum-verified raw load: ``({path_key: array}, manifest)``; a
    bf16 leaf comes as its ``uint16`` bits (``manifest['bfloat16']``)."""
    manifest = verify(path)
    with np.load(path + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, manifest


def _tensor(arr: np.ndarray, bf16: bool, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def load_tensors(path: str, device="cpu"
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Checksum-verified load as tensors on ``device``, bf16 leaves
    restored bit for bit: ``({path_key: tensor}, manifest)``."""
    arrays, manifest = load_arrays(path)
    bf16 = set(manifest.get(BF16_KEY, ()))
    return ({k: _tensor(a, k in bf16, device) for k, a in arrays.items()},
            manifest)


def restore(path: str, like):
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf takes the stored array, in its stored dtype, on the device of
    ``like``'s leaf.  The payload checksum is verified first."""
    data, _ = load_tensors(path)
    missing = [k for k in _flatten_with_paths(like) if k not in data]
    if missing:
        raise ValueError(f"checkpoint {path!r} lacks leaves {missing[:3]}"
                         f"{'…' if len(missing) > 3 else ''}")

    def one(p, leaf):
        t = data[_key(p)]
        return t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t

    return tree_map_with_path(one, like)


def latest_step(path: str) -> Optional[int]:
    try:
        with open(path + ".json") as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None


__all__ = ["save", "verify", "load_arrays", "load_tensors", "restore",
           "latest_step"]
