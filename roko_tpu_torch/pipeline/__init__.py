"""The streaming polish engine (``stream``): extraction, batching and
device inference overlapped, the default of ``polish``; and the
distributed polish over the worker fleet (``distpolish``).

Exports resolve lazily (PEP 562): ``stream`` imports torch, and the
fleet's supervisor, which wires ``POST /job`` through
:mod:`roko_tpu_torch.pipeline.distpolish`, never does.
"""

_EXPORTS = {
    "run_streaming_polish": ("roko_tpu_torch.pipeline.stream", "run_streaming_polish"),
    "run_distributed_polish": ("roko_tpu_torch.pipeline.distpolish",
                               "run_distributed_polish"),
    "PoisonedUnit": ("roko_tpu_torch.pipeline.distpolish", "PoisonedUnit"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        mod, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(mod), attr)
