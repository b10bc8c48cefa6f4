"""Warm model session with a padded batch ladder (the port's counterpart
of ``roko_tpu/serve/session.py::PolishSession``).

A :class:`PolishSession` holds a :class:`RokoModel` on one device, in
``eval()``, and dispatches every request by padding it to the smallest
rung of a small ladder of batch sizes that fits (chunking oversized
requests at the top rung), so the kernels run at a few known shapes
whatever window counts requests arrive with. ``dispatched_shapes``
records every padded batch size that reached the device.

Each dispatch runs under the resilience watchdog (``call_with_deadline``)
with split budgets: the first dispatch of a rung gets
``compile_deadline_s`` (on the card that first call also builds the
recurrent kinds' kernels with nvcc), every later one ``predict_deadline_s``. A blown
deadline raises :class:`HangError`. The class ids come back to the host
synchronously.

What the JAX package's session does and this one does not: shard over a
device mesh (one card here; multi-GPU is queue item A8), load AOT bundles
or a persistent compile cache (A9.3), run a ragged step (A9.2), or fail
over to the host CPU after a hang (not ported: carrying on on the CPU
after the card failed would hide the card's failure).
``warmup`` runs each rung once through the model and does nothing else.
The model runs in its resolved ``cfg.compute_dtype``; a config that asks
for int8 quantizes it once, when the session is built.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Set, Tuple

import numpy as np
import torch

from roko_tpu_torch.config import RokoConfig, resolve_ladder, validate_ladder
from roko_tpu_torch.infer import (
    pad_windows,
    resolve_device,
    rung_for,
    use_float32_matmuls,
)
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.models.quant import maybe_quantize
from roko_tpu_torch.resilience import DeadlinePolicy, call_with_deadline


class PolishSession:
    """A model on its device + the padded batch ladder; thread-safe
    dispatch (``predict`` serialises device work with a lock)."""

    #: the dp extent: the port's session drives one device
    dp = 1

    def __init__(
        self,
        model: RokoModel,
        cfg: Optional[RokoConfig] = None,
        *,
        device: str | torch.device = "cuda",
        ladder: Optional[Sequence[int]] = None,
    ):
        self.cfg = cfg or RokoConfig(model=model.cfg)
        self.device = resolve_device(device)
        rungs = (
            resolve_ladder(self.cfg.serve, self.dp)
            if ladder is None
            else tuple(sorted(set(ladder)))
        )
        if not rungs:
            raise ValueError("ladder must name at least one batch size")
        validate_ladder(rungs, self.dp)
        self.ladder: Tuple[int, ...] = rungs
        # process-wide, so the batcher's thread sees it too
        use_float32_matmuls()
        # conversion-time int8 (models/quant.py): once, at session build;
        # every rung then runs in the model's resolved compute dtype
        self.model = maybe_quantize(model).to(self.device).eval()
        self._lock = threading.Lock()
        #: padded batch sizes that have reached the device — always a
        #: subset of ``ladder``
        self.dispatched_shapes: Set[int] = set()
        res = self.cfg.resilience
        self._deadlines = DeadlinePolicy(res.predict_deadline_s, res.compile_deadline_s)
        w = model.cfg
        self._window_shape = (w.window_rows, w.window_cols)

    def warmup(self) -> int:
        """Run one zero batch of every rung through the model (on the
        card, the first call builds the kernels); returns the rung count."""
        for rung in self.ladder:
            with self._lock:
                self._dispatch(np.zeros((rung,) + self._window_shape, np.uint8))
        return len(self.ladder)

    # -- dispatch -----------------------------------------------------------

    def rung_for(self, n: int) -> int:
        """Smallest ladder rung >= n (top rung when none fits)."""
        return rung_for(self.ladder, n)

    def padded_size(self, n: int) -> int:
        """Total padded rows ``predict`` dispatches for an n-window batch
        (top-rung chunks + one padded tail rung)."""
        top = self.ladder[-1]
        full, rest = divmod(n, top)
        return full * top + (self.rung_for(rest) if rest else 0)

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """uint8[rung, rows, cols] -> int32[rung, cols] class ids, copied
        back to the host. Runs on the watchdog's thread: the inference
        mode and the current device are per thread, so both are set here."""
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            with torch.inference_mode():
                xt = torch.from_numpy(x).to(self.device)
                preds = self.model(xt).argmax(dim=-1).to(torch.int32)
                return preds.cpu().numpy()

    def _dispatch(self, x: np.ndarray) -> np.ndarray:
        """One padded batch through the device, under the watchdog."""
        rung = x.shape[0]
        self.dispatched_shapes.add(rung)
        deadline_s, first = self._deadlines.deadline_for(rung)
        try:
            return call_with_deadline(
                lambda: self._forward(x),
                deadline_s,
                stage="serve-compile" if first else "serve-predict",
            )
        except BaseException:
            # a failed first dispatch re-arms the first-call budget, so a
            # retry is not judged by the tight predict deadline
            if first:
                self._deadlines.forget(rung)
            raise

    def predict(self, x: np.ndarray) -> np.ndarray:
        """uint8[n, rows, cols] -> int32[n, cols] class ids, padding to
        the ladder (chunked at the top rung)."""
        x = np.ascontiguousarray(x, dtype=np.uint8)
        if x.ndim != 3 or x.shape[1:] != self._window_shape:
            raise ValueError(
                f"windows shaped {x.shape}, want (n,) + {self._window_shape}"
            )
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, self._window_shape[1]), np.int32)
        if not x.flags.writeable:  # torch.from_numpy wants a writeable array
            x = x.copy()
        top = self.ladder[-1]
        outs = []
        with self._lock:
            for s in range(0, n, top):
                chunk = x[s : s + top]
                rung = self.rung_for(chunk.shape[0])
                preds = self._dispatch(pad_windows(chunk, rung))
                outs.append(preds[: chunk.shape[0]])
        return outs[0] if len(outs) == 1 else np.concatenate(outs)
