"""The streaming polish engine (``stream``): extraction, batching and
device inference overlapped, the default of ``polish``."""

from roko_tpu_torch.pipeline.stream import run_streaming_polish

__all__ = ["run_streaming_polish"]
