"""Parameter bridge between the flax tree of `pwn_tpu` and the port's
state_dict.

The port keeps the flax names and shapes, so a state_dict key is the flax
path joined with "." (`flow_0/layer_3/w_dilated` ->
`flow_0.layer_3.w_dilated`) and conversion is a copy.  Restoring an orbax
checkpoint needs JAX and is not done here: pass the restored tree as
numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = v
    return flat


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays; a `{"params": ...}`
    variables dict is unwrapped) -> float32 state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in _flatten(tree).items()
    }


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """state_dict -> nested flax-layout dict of float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return tree


def save_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a state_dict as a flat npz of float32 arrays."""
    np.savez(path, **{k: t.detach().to("cpu", torch.float32).numpy()
                      for k, t in state_dict.items()})


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a flat npz written by `save_npz` into a state_dict."""
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k].copy()) for k in data.files}
