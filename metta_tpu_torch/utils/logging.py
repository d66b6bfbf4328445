"""Metrics logging: a JSONL file in the run dir, and wandb where it is installed
and asked for.

The port's copy of ``metta_tpu/utils/logging.py`` (reference
``common/wandb/context.py`` + ``training/stats_reporter.py``): wandb is
optional; without it, metrics go to ``metrics.jsonl`` in the run dir, one
``{"_time", **payload}`` line a call, flushed each time.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)


class MetricsLogger:
    """Console + JSONL (+ wandb when available and configured)."""

    def __init__(self, run_dir: Optional[str] = None, wandb_project: Optional[str] = None,
                 run_name: str = "run"):
        self._jsonl = None
        if run_dir:
            Path(run_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(Path(run_dir) / "metrics.jsonl", "a")
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=run_name)
            except ImportError:
                logger.warning("wandb not installed; logging to console/jsonl only")

    def log(self, payload: dict, step: Optional[int] = None):
        if self._jsonl:
            self._jsonl.write(json.dumps({"_time": time.time(), **payload}) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(payload, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
