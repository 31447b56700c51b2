"""Ship-weight artifact: ONE bit-plane file serves every precision (port of
``repro.ckpt.ship``).

``weights-bitplane-v1`` stores the weights bit-serially (``layout=
'bitplane'``: a sign plane + magnitude planes, MSB first), so one artifact
on disk serves any precision 1..``bits`` — the loader takes the top-k
planes through ``QTensor.slice_planes(k)`` and never uses the rest.

The on-disk layout is the reference's, byte for byte in meaning, so an
artifact written by either package loads in the other:

    <dir>/
      manifest.json   format, stored bits, per-leaf path/kind/scheme/dtype
      arrays.npz      leaf_i_codes + leaf_i_scale (QTensor) or leaf_i (array)
      .complete       readers ignore directories without it

Leaves are numbered in sorted-key order (the reference's tree order);
bitplane words are stored as ``uint32`` (the port holds them as ``int32``,
the same bits); bf16 is stored viewed as ``uint16`` with the dtype recorded
per leaf, and read back through a torch view. The save is atomic: a
temporary directory renamed into place, ``.complete`` written last.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.quant import QScheme, QTensor

FORMAT = "weights-bitplane-v1"


class ShipArtifactError(RuntimeError):
    """A committed ship-weights artifact is unreadable — truncated,
    bit-rotted, or torn by a partial copy. The ``.complete`` marker guards
    against interrupted writes; this error covers corruption found after
    commit, and names the fix (re-run :func:`save_ship_weights` or restore
    the artifact from a good copy)."""


def _leaves(tree, path=()):
    """(key path, leaf) pairs in sorted-key order, QTensors as leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield list(path), tree


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor as numpy with the dtype name the reference records; 16-bit
    floats go through a ``uint16`` view (npz has no portable bf16)."""
    t = t.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _unhost(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if a.dtype == np.uint16 and "float" in dtype:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(getattr(torch, dtype)).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def save_ship_weights(directory: str, params: Any, *,
                      extra: dict | None = None) -> str:
    """Write ``params`` (a bitplane-quantized tree) as one any-precision
    artifact. Needs at least one ``layout='bitplane'`` QTensor leaf — use
    ``quantize_param_tree(..., layout='bitplane')`` first."""
    manifest_leaves, arrays = [], {}
    bits = 0
    leaves = list(_leaves(params))
    for i, (path, leaf) in enumerate(leaves):
        entry: dict = {"path": path}
        if isinstance(leaf, QTensor):
            if leaf.scheme.layout != "bitplane":
                raise ValueError(
                    f"{FORMAT} stores bitplane QTensors only; leaf {path} has "
                    f"layout={leaf.scheme.layout!r} — quantize with "
                    "quantize_param_tree(..., layout='bitplane')")
            entry["kind"] = "qtensor"
            entry["scheme"] = dataclasses.asdict(leaf.scheme)
            arrays[f"leaf_{i}_codes"] = _host(leaf.codes)[0].view(np.uint32)
            arrays[f"leaf_{i}_scale"], entry["scale_dtype"] = _host(leaf.scale)
            bits = max(bits, leaf.scheme.bits)
        else:
            entry["kind"] = "array"
            arrays[f"leaf_{i}"], entry["dtype"] = _host(leaf)
        manifest_leaves.append(entry)
    if bits == 0:
        raise ValueError(f"{FORMAT} needs at least one bitplane QTensor leaf — got none")
    manifest = {"format": FORMAT, "bits": bits, "n_leaves": len(leaves),
                "leaves": manifest_leaves, "extra": extra or {}}
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(directory)) or ".",
                           prefix=".tmp_ship_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        open(os.path.join(tmp, ".complete"), "w").close()
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return directory


def _insert(tree: dict, keys: list, value) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _listify(node):
    """Dicts whose keys are exactly 0..n-1 were list levels — restore them."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node) \
            and sorted(node) == list(range(len(node))):
        return [node[i] for i in range(len(node))]
    return node


def load_ship_weights(directory: str, bits: int | None = None, *,
                      device=None) -> Any:
    """Rebuild the param tree from a ``weights-bitplane-v1`` artifact on
    ``device`` (default ``cuda``).

    ``bits=k`` serves the top-k planes (``slice_planes`` on every bitplane
    leaf — the same values as quantizing directly at k bits); ``None``
    loads the full stored precision."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    if not os.path.exists(os.path.join(directory, ".complete")):
        raise FileNotFoundError(
            f"{directory} is not a committed ship artifact (.complete missing "
            "— the save was interrupted before commit; re-run save_ship_weights)")
    try:
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ShipArtifactError(
            f"{directory} is corrupt: manifest.json is missing or unreadable "
            f"({e}) despite the .complete marker — restore the artifact from a "
            "good copy or re-run save_ship_weights") from e
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{directory} has format {manifest.get('format')!r}, "
                         f"expected {FORMAT!r}")
    if bits is not None and not 1 <= bits <= manifest["bits"]:
        raise ValueError(f"bits={bits} not servable by a {manifest['bits']}-bit artifact")
    # a truncated npz fails in several ways (BadZipFile, EOFError, zlib.error,
    # KeyError, ValueError); all mean the committed data is unreadable
    try:
        data = np.load(os.path.join(directory, "arrays.npz"))
        tree: dict = {}
        for i, entry in enumerate(manifest["leaves"]):
            if entry["kind"] == "qtensor":
                codes = np.ascontiguousarray(data[f"leaf_{i}_codes"]).view(np.int32)
                leaf = QTensor(torch.from_numpy(codes).to(dev),
                               _unhost(data[f"leaf_{i}_scale"], entry["scale_dtype"], dev),
                               QScheme(**entry["scheme"]))
                if bits is not None and bits < leaf.scheme.bits:
                    leaf = leaf.slice_planes(bits)
            else:
                leaf = _unhost(data[f"leaf_{i}"], entry["dtype"], dev)
            _insert(tree, entry["path"], leaf)
    except (zipfile.BadZipFile, OSError, EOFError, KeyError, ValueError,
            zlib.error) as e:
        raise ShipArtifactError(
            f"{directory} is corrupt or truncated: arrays.npz failed to read "
            f"({type(e).__name__}: {e}) despite the .complete marker — the data "
            "was damaged after commit; restore the artifact from a good copy or "
            "re-run save_ship_weights") from e
    return _listify(tree)


__all__ = ["FORMAT", "ShipArtifactError", "load_ship_weights", "save_ship_weights"]
