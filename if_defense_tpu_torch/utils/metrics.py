"""Metrics sink: JSONL file + stdout (a copy of
`if_defense_tpu/utils/metrics.py`)."""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, **metrics):
        record = {"time": time.time(), **metrics}
        line = json.dumps(record, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, flush=True)
        return record
