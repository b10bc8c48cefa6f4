"""NaN/loss-spike sentinel of the train loop.

The port's copy of ``roko_tpu/training/guard.py`` (:65-211). The train
step computes the loss and the gradients first; the host then asks
:meth:`TrainGuard.check` whether to apply the update:

- a non-finite loss or gradient, or a loss more than ``spike_sigma`` EMA
  standard deviations above the loss EMA, skips the update (parameters
  and optimizer state untouched);
- ``max_bad_steps`` skips in a row raise :class:`RollbackRequested`, and
  the loop restores the last good checkpoint with a re-seeded dropout
  stream.

Every event is one ``ROKO_GUARD event=... k=v`` line through ``log``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

from roko_tpu_torch.config import GuardConfig


def guard_line(event: str, **fields: Any) -> str:
    """``ROKO_GUARD event=<event> k=v ...``, floats as ``%.6g``, keys in
    call order."""
    parts = ["ROKO_GUARD", f"event={event}"]
    for k, v in fields.items():
        parts.append(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}")
    return " ".join(parts)


class RollbackRequested(RuntimeError):
    """Consecutive bad steps exhausted ``max_bad_steps``, or an applied
    update left non-finite parameters."""

    def __init__(self, reason: str, step: int):
        super().__init__(f"guard requested rollback at step {step} (reason: {reason})")
        self.reason = reason
        self.step = step


class TrainGuard:
    """Loss EMA and variance EMA, the consecutive-bad count, event
    counters."""

    def __init__(self, cfg: GuardConfig, log: Callable[[str], None] = print):
        self.cfg = cfg
        self._log = log
        self.ema: Optional[float] = None
        self.var = 0.0
        self.good_steps = 0
        self.consecutive_bad = 0
        self.counters: Dict[str, int] = {
            "skipped_nonfinite": 0,
            "skipped_spike": 0,
            "param_nonfinite": 0,
            "rollbacks": 0,
        }

    def spike_threshold(self) -> Optional[float]:
        """The loss above which a step is a spike, or None while the EMA
        warms up. The variance EMA starts at zero, so it is bias-corrected
        by ``1 - beta^n`` as Adam's moments are."""
        if self.ema is None or self.good_steps < self.cfg.warmup_steps:
            return None
        updates = max(self.good_steps - 1, 1)  # the first good step only sets the EMA
        bias = max(1.0 - self.cfg.ema_beta ** updates, 1e-12)
        return self.ema + self.cfg.spike_sigma * max(math.sqrt(self.var / bias), 1e-8)

    def check(self, step: int, loss: float, grads_finite: bool) -> bool:
        """True to apply the step's update, False to skip it; raises
        :class:`RollbackRequested` after ``max_bad_steps`` skips in a row."""
        reason = None
        if not grads_finite or not math.isfinite(loss):
            reason = "nonfinite"
        else:
            threshold = self.spike_threshold()
            if threshold is not None and loss > threshold:
                reason = "spike"
        if reason is None:
            if self.ema is None:
                self.ema = loss
            else:
                beta = self.cfg.ema_beta
                prev = self.ema
                self.ema = beta * prev + (1.0 - beta) * loss
                self.var = beta * self.var + (1.0 - beta) * (loss - prev) ** 2
            self.good_steps += 1
            self.consecutive_bad = 0
            return True

        self.consecutive_bad += 1
        self.counters[f"skipped_{reason}"] += 1
        self._log(guard_line(
            "skip", reason=reason, step=step, loss=loss,
            ema=self.ema if self.ema is not None else float("nan"),
            consecutive=self.consecutive_bad, max_bad_steps=self.cfg.max_bad_steps,
        ))
        if self.consecutive_bad >= self.cfg.max_bad_steps:
            raise RollbackRequested(reason, step)
        return False

    def params_nonfinite(self, step: int) -> None:
        """An applied update left non-finite parameters: the old ones are
        gone, so this rolls back at once."""
        self.counters["param_nonfinite"] += 1
        self._log(guard_line("param_nonfinite", step=step, action="rollback"))
        raise RollbackRequested("param_nonfinite", step)

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs to decide as an uninterrupted one would."""
        return {
            "ema": self.ema if self.ema is not None else float("nan"),
            "var": self.var,
            "good_steps": self.good_steps,
            "consecutive_bad": self.consecutive_bad,
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        ema = float(state["ema"])
        self.ema = None if math.isnan(ema) else ema
        self.var = float(state["var"])
        self.good_steps = int(state["good_steps"])
        self.consecutive_bad = int(state["consecutive_bad"])

    def note_rollback(self) -> None:
        """After a rollback the EMA restarts from the restored run."""
        self.counters["rollbacks"] += 1
        self.consecutive_bad = 0
        self.ema = None
        self.var = 0.0
        self.good_steps = 0

    @property
    def skipped(self) -> int:
        return self.counters["skipped_nonfinite"] + self.counters["skipped_spike"]

    @property
    def events(self) -> int:
        return self.skipped + self.counters["param_nonfinite"] + self.counters["rollbacks"]

    def summary(self) -> str:
        c = self.counters
        return (
            f"guard: skipped={self.skipped} "
            f"(nonfinite={c['skipped_nonfinite']} spike={c['skipped_spike']}) "
            f"param_nonfinite={c['param_nonfinite']} rollbacks={c['rollbacks']}"
        )
