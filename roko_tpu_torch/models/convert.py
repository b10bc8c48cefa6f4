"""Weights bridge between the JAX param tree and the port's state_dict.

``state_dict_from_jax`` is ``roko_tpu/models/convert.py:33-59`` run in
reverse: the JAX tree stores ``[in, out]`` dense kernels and ``[in, 3H]``
GRU weights, the reference torch layout the transposes, with the same
(r, z, n) gate order, so the bridge transposes and renames and nothing
else. A ``kind="lingru"`` tree's ``params["lingru"]`` (``w_zx``, ``w_cx``
[in, H]; ``b_z``, ``b_c`` [H]) maps the same way onto the port's
``lingru.weight_zx_l{k}[_reverse]`` etc. ``jax_from_state_dict`` is the
way back, so tests can hold trained parameters and gradients against the
JAX package's. Reading an Orbax checkpoint directory needs JAX and is not
part of the port.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

from roko_tpu_torch.models import lingru

_DIRECTIONS = (("fwd", ""), ("bwd", "_reverse"))
#: per kind: (JAX name, port name, transposed?) of one layer's direction
_RECURRENT = {
    "gru": (("w_ih", "weight_ih", True), ("w_hh", "weight_hh", True),
            ("b_ih", "bias_ih", False), ("b_hh", "bias_hh", False)),
    "lingru": lingru.PARAMS,
}


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree of arrays (``{"embedding", "fc1", "fc2", "head",
    "gru" or "lingru": ({"fwd", "bwd"}, ...)}``) -> reference-layout
    state_dict."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    sd["embedding.weight"] = _t(params["embedding"])
    for name, key in (("fc1", "fc1"), ("fc2", "fc2"), ("fc4", "head")):
        sd[f"{name}.weight"] = _t(params[key]["kernel"]).t().contiguous()
        sd[f"{name}.bias"] = _t(params[key]["bias"])
    for kind, names in _RECURRENT.items():
        for k, layer in enumerate(params.get(kind, ())):
            for direction, suffix in _DIRECTIONS:
                for jax_name, name, transpose in names:
                    t = _t(layer[direction][jax_name])
                    sd[f"{kind}.{name}_l{k}{suffix}"] = t.t().contiguous() if transpose else t
    return sd


def jax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Reference-layout state_dict -> JAX param tree of float32 numpy
    arrays, the inverse of :func:`state_dict_from_jax`."""

    def a(name: str, transpose: bool = False) -> np.ndarray:
        t = sd[name].detach().cpu().float()
        return (t.t() if transpose else t).contiguous().numpy()

    tree: Dict[str, Any] = {"embedding": a("embedding.weight")}
    for name, key in (("fc1", "fc1"), ("fc2", "fc2"), ("fc4", "head")):
        tree[key] = {"kernel": a(f"{name}.weight", True), "bias": a(f"{name}.bias")}
    kind = "lingru" if "lingru.weight_zx_l0" in sd else "gru"
    names = _RECURRENT[kind]
    layers = []
    while f"{kind}.{names[0][1]}_l{len(layers)}" in sd:
        k = len(layers)
        layers.append({
            direction: {
                jax_name: a(f"{kind}.{name}_l{k}{suffix}", transpose)
                for jax_name, name, transpose in names
            }
            for direction, suffix in _DIRECTIONS
        })
    tree[kind] = tuple(layers)
    return tree


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout roko ``.pth`` state_dict, loaded to the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping) or "embedding.weight" not in sd:
        raise ValueError(f"{path} does not look like a roko RNN state_dict")
    return sd
