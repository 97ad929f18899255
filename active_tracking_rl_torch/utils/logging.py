"""Text logger and metric writer.

The port's copy of ``active_tracking_rl_tpu/utils/logging.py``: the same
logger format and the same scalar records. Scalars always go to
``metrics.jsonl`` in the run directory, one JSON object a line (``step``,
``wall`` and the scalars); to TensorBoard as well where
``torch.utils.tensorboard`` can be imported.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict


def setup_logger(name: str, log_file: str,
                 level: int = logging.INFO) -> logging.Logger:
    """A logger that writes `log_file` and the console."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s : %(message)s")
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file, mode="w")
        fh.setFormatter(fmt)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(sh)
    return logger


def close_logger(logger: logging.Logger) -> None:
    """Close and drop its handlers, so the name can log elsewhere next."""
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None
        self._t0 = time.time()

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "wall": time.time() - self._t0}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
