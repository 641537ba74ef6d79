"""Checkpointing: one ``.npz`` + JSON manifest for nested dicts of tensors
(the port of ``repro.checkpoint.store``, in the same format).

Leaves are flattened in sorted key order, as ``jax.tree_util`` flattens a
dict, under path-derived keys ``{i:05d}__{key}/{key}/...``; the manifest
records their order. So a checkpoint of a tree of nested dicts is the same
file in both packages: the reference's checkpoint of its parameters
restores here (with no template) and loads through
``models.transformer.from_jax_params``. Tensors round-trip through host
numpy; bfloat16, which numpy lacks, is stored as its int16 bit pattern and
restored as bfloat16 by its template.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["save_pytree", "restore_pytree"]


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def save_pytree(tree: Mapping[str, Any], directory: str,
                name: str = "ckpt") -> str:
    """Write ``tree`` (nested dicts of tensors or arrays) to
    ``directory/name.npz`` and its manifest to ``name.json``; returns the
    ``.npz`` path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    manifest = {"order": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        k = f"{i:05d}__{path}"
        arrays[k] = _to_numpy(leaf)
        manifest["order"].append(k)
    np.savez(os.path.join(directory, f"{name}.npz"), **arrays)
    with open(os.path.join(directory, f"{name}.json"), "w") as f:
        json.dump(manifest, f)
    return os.path.join(directory, f"{name}.npz")


def restore_pytree(template: Optional[Mapping[str, Any]], directory: str,
                   name: str = "ckpt") -> Dict[str, Any]:
    """Read a checkpoint back as nested dicts of tensors.

    With a ``template`` (nested dicts of tensors), its structure must match
    the checkpoint's, leaf for leaf and shape for shape, and each leaf is
    restored onto its template leaf's device and dtype. Without one, the
    tree is rebuilt from the manifest's paths as CPU tensors.
    """
    with open(os.path.join(directory, f"{name}.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(directory, f"{name}.npz"))
    order = manifest["order"]
    paths = [k.split("__", 1)[1] for k in order]
    if template is None:
        out: Dict[str, Any] = {}
        for k, path in zip(order, paths):
            *parents, leaf = path.split("/")
            node = out
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = torch.from_numpy(data[k])
        return out
    flat = list(_flatten(template))
    if [p for p, _ in flat] != paths:
        raise ValueError(f"{name}: the checkpoint's leaves do not match the "
                         "template's")
    leaves = {}
    for k, (path, like) in zip(order, flat):
        arr = data[k]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path}: checkpoint shape {arr.shape}, "
                             f"template {tuple(like.shape)}")
        t = torch.from_numpy(arr)
        if like.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        leaves[path] = t.to(device=like.device, dtype=like.dtype)
    return _rebuild(template, leaves)


def _rebuild(template: Mapping[str, Any], leaves: Dict[str, torch.Tensor],
             prefix: str = "") -> Dict[str, Any]:
    return {key: (_rebuild(val, leaves, f"{prefix}{key}/")
                  if isinstance(val, Mapping) else leaves[f"{prefix}{key}"])
            for key, val in template.items()}
