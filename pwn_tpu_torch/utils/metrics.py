"""Structured metrics logging (counterpart of `pwn_tpu/utils/metrics.py`).

One jsonl line per log event with `step` and `wall_s`, a mirror on
stderr, and (optional) TensorBoard event files through the port's
dependency-free writer (`utils/tensorboard.py`).  A metric that is a
tensor on the card becomes a float through `float(v)`: one device sync
per logged step, at the loop's `log_every`.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

from pwn_tpu_torch.utils.tensorboard import SummaryWriter


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tb_dir: Optional[str] = None):
        self._file = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a", buffering=1)
        self._echo = echo
        self._t0 = time.time()
        self._tb = SummaryWriter(tb_dir) if tb_dir else None

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {
            "step": int(step),
            "wall_s": round(time.time() - self._t0, 3),
        }
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
        if self._tb:
            self._tb.add_scalars(
                step, **{k: v for k, v in rec.items()
                         if isinstance(v, float) and k != "wall_s"}
            )
            self._tb.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def add_audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        """A TensorBoard audio summary when a TB dir is configured; no-op
        otherwise."""
        if self._tb:
            self._tb.add_audio(tag, wav, sample_rate, step=step)
            self._tb.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
