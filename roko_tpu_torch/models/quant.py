"""Weight-only int8 quantization of the consensus models.

Counterpart of ``roko_tpu/models/quant.py``. Each targeted matrix is
stored as

    q:     int8, round(w / scale) clipped to +-127 (round half to even)
    scale: float32 [out], max |w| over the input axis / 127

with one scale per output channel, and dequantized where it feeds its
product (``layers.weight``): the multiply in float32, then one cast to
the compute dtype. Everything else stays float: the embedding, every
bias, the recurrences' state and the logits.

The port stores its matrices as ``torch.nn`` does, ``[out, in]``, where
the JAX tree stores ``[in, out]``: an output channel is a row here and a
column there, so a quantized state_dict holds ``<name>_q`` ``[out, in]``
(the JAX ``q`` transposed) and ``<name>_scale`` ``[out]`` (the JAX
``scale``) in place of ``<name>``, and the two packages reach the same
bits.

Targets: ``fc1``, ``fc2`` and ``fc4`` (the JAX tree's ``head``), and per
layer and direction ``gru.weight_ih``/``weight_hh`` or
``lingru.weight_zx``/``weight_cx``.

Quantization is conversion-time only: training refuses a quantized
config, and inference, the streaming polish and the session quantize the
float32 model once, when they load it (:func:`maybe_quantize`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import torch

from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models.layers import dequant_weight

#: symmetric int8 range: +-127 keeps the scale symmetric
QMAX = 127.0
_DENSE = ("fc1.weight", "fc2.weight", "fc4.weight")
_RECURRENT = ("gru.weight_ih_l", "gru.weight_hh_l", "lingru.weight_zx_l", "lingru.weight_cx_l")
_Q, _SCALE = "_q", "_scale"


def is_target(name: str) -> bool:
    """Whether state_dict entry ``name`` is a matrix that int8 quantizes."""
    return name in _DENSE or name.startswith(_RECURRENT)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A float32 matrix [out, in] -> ``{"q": int8 [out, in], "scale":
    float32 [out]}``, absmax scales per output channel (per row)."""
    absmax = w.abs().amax(dim=tuple(range(1, w.dim())))
    # an all-zero channel would divide 0 by 0; its q row is 0 either way
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax)).float() / QMAX
    shape = (-1,) + (1,) * (w.dim() - 1)
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -QMAX, QMAX).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_params(sd: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A float32 state_dict -> the quantized one for ``cfg`` (whose
    ``quantize`` must be "int8"): each target ``<name>`` replaced by
    ``<name>_q`` and ``<name>_scale``, everything else as it was."""
    if cfg.quantize != "int8":
        raise ValueError(f"unsupported quantize mode {cfg.quantize!r}")
    out: Dict[str, torch.Tensor] = OrderedDict()
    for name, t in sd.items():
        if is_target(name):
            qw = quantize_weight(t)
            out[name + _Q], out[name + _SCALE] = qw["q"], qw["scale"]
        else:
            out[name] = t
    return out


def is_quantized(sd: Mapping[str, torch.Tensor]) -> bool:
    """Whether a state_dict already holds int8 matrices."""
    return any(name.endswith(_Q) and is_target(name[: -len(_Q)]) for name in sd)


def dequantize_params(
    sd: Mapping[str, torch.Tensor], dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """A quantized state_dict back to dense matrices in ``dtype`` (the
    other entries as they are)."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for name, t in sd.items():
        if name.endswith(_SCALE) and is_target(name[: -len(_SCALE)]):
            continue
        if name.endswith(_Q) and is_target(name[: -len(_Q)]):
            base = name[: -len(_Q)]
            # dequant_weight takes the JAX layout, the scale on the last axis
            w = {"q": t.t(), "scale": sd[base + _SCALE]}
            out[base] = dequant_weight(w, dtype).t().contiguous()
        else:
            out[name] = t
    return out


@torch.no_grad()
def maybe_quantize(model: torch.nn.Module) -> torch.nn.Module:
    """The one conversion gate a model is loaded for inference through:
    when ``model.cfg.quantize`` asks for int8 and the model is not
    quantized yet, each target parameter ``<name>`` is replaced, in
    place, by the buffers ``<name>_q`` and ``<name>_scale`` (on the
    parameter's device); otherwise the model is left as it is. Returns
    the model."""
    if model.cfg.quantize is None or is_quantized(model.state_dict()):
        return model
    for name, t in quantize_params(dict(model.named_parameters()), model.cfg).items():
        if not name.endswith((_Q, _SCALE)):
            continue
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        base = attr[: -len(_Q)] if attr.endswith(_Q) else attr[: -len(_SCALE)]
        if base in owner._parameters:
            delattr(owner, base)
        owner.register_buffer(attr, t)
    return model
