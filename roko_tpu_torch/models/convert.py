"""Weights bridge between the JAX param tree and the port's state_dict.

``state_dict_from_jax`` is ``roko_tpu/models/convert.py:33-59`` run in
reverse: the JAX tree stores ``[in, out]`` dense kernels and ``[in, 3H]``
GRU weights, the reference torch layout the transposes, with the same
(r, z, n) gate order, so the bridge transposes and renames and nothing
else; ``jax_from_state_dict`` is the way back, so tests can hold trained
parameters and gradients against the JAX package's. Reading an Orbax
checkpoint directory needs JAX and is not part of the port.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree of arrays (``{"embedding", "fc1", "fc2", "head",
    "gru": ({"fwd", "bwd"}, ...)}``) -> reference-layout state_dict."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    sd["embedding.weight"] = _t(params["embedding"])
    for name, key in (("fc1", "fc1"), ("fc2", "fc2"), ("fc4", "head")):
        sd[f"{name}.weight"] = _t(params[key]["kernel"]).t().contiguous()
        sd[f"{name}.bias"] = _t(params[key]["bias"])
    for k, layer in enumerate(params["gru"]):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            p = layer[direction]
            sd[f"gru.weight_ih_l{k}{suffix}"] = _t(p["w_ih"]).t().contiguous()
            sd[f"gru.weight_hh_l{k}{suffix}"] = _t(p["w_hh"]).t().contiguous()
            sd[f"gru.bias_ih_l{k}{suffix}"] = _t(p["b_ih"])
            sd[f"gru.bias_hh_l{k}{suffix}"] = _t(p["b_hh"])
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
    layers = []
    k = 0
    while f"gru.weight_ih_l{k}" in sd:
        layers.append({
            direction: {
                "w_ih": a(f"gru.weight_ih_l{k}{suffix}", True),
                "w_hh": a(f"gru.weight_hh_l{k}{suffix}", True),
                "b_ih": a(f"gru.bias_ih_l{k}{suffix}"),
                "b_hh": a(f"gru.bias_hh_l{k}{suffix}"),
            }
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))
        })
        k += 1
    tree["gru"] = tuple(layers)
    return tree


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout roko ``.pth`` state_dict, loaded to the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping) or "embedding.weight" not in sd:
        raise ValueError(f"{path} does not look like a roko RNN state_dict")
    return sd
