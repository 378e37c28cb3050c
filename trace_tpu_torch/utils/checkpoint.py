"""Checkpoint / resume for integrator state (port of
trace_tpu/utils/checkpoint.py).

A state (a dataclass of tensors or of such dataclasses, e.g. SPPMState)
is saved as one .npz in the JAX package's layout: ``leaf_<i>`` for the
i-th tensor in field declaration order (the order JAX flattens the same
dataclass), plus ``meta_<key>`` entries. A checkpoint written by either
package loads in the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    return [leaf for f in dataclasses.fields(tree)
            for leaf in _leaves(getattr(tree, f.name))]


def _rebuild(like, leaves):
    """``like``'s structure with its tensors taken from ``leaves`` in
    order (consumed from the front)."""
    if torch.is_tensor(like):
        return leaves.pop(0)
    return type(like)(**{f.name: _rebuild(getattr(like, f.name), leaves)
                         for f in dataclasses.fields(like)})


def save_pytree(path: str, tree, metadata: dict | None = None) -> None:
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(_leaves(tree))}
    for k, v in (metadata or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load_pytree(path: str, like):
    """The leaves saved at ``path`` in the structure of ``like``, each on
    its template leaf's device."""
    with np.load(path) as data:
        loaded = []
        for i, ref in enumerate(_leaves(like)):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} "
                                 f"!= expected {tuple(ref.shape)}")
            loaded.append(torch.from_numpy(arr).to(ref.device))
    return _rebuild(like, loaded)


def load_metadata(path: str) -> dict:
    with np.load(path) as data:
        return {k[len("meta_"):]: data[k] for k in data.files
                if k.startswith("meta_")}
