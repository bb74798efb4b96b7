"""Metrics journal (counterpart of ``nuzero_tpu/utils/metrics.py``'s
``MetricsJournal``): an append-only JSONL journal, one record per training
step.  The progress bar is ``utils/printbar.py``'s, as in the JAX
pipeline."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsJournal:
    def __init__(self, path: Optional[str], write: bool = True):
        """``write=False`` makes appends and truncates no-ops while keeping
        ``load`` functional."""
        self.path = path
        self.write = write
        if path and write:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def append(self, record: Dict[str, Any]) -> None:
        record = dict(record, ts=time.time())
        if self.path and self.write:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def load(self) -> List[Dict[str, Any]]:
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def truncate_to_step(self, step: int) -> None:
        """Resume support: drop records past ``step``."""
        records = [r for r in self.load() if r.get("step", 0) <= step]
        if self.path and self.write:
            with open(self.path, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
