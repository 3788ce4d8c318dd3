"""Structured metrics logging (the port's copy of dan_tpu/utils/logging.py):
a JSONL metrics file and a line on stderr a record."""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    """Appends {"step", "time" (seconds since the logger was made),
    **metrics as floats} to <log_dir>/<name>_metrics.jsonl and echoes the
    record to stderr.  Without log_dir it only echoes."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self.path = None
        self._f = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
            self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], echo: bool = True):
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if echo:
            kv = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k != "time"
            )
            print(f"[{rec['time']:9.1f}s] {kv}", file=sys.stderr)

    def close(self):
        if self._f:
            self._f.close()
