"""Structured metric logging (the port's copy of ``tpurec/utils/logging.py``:
the reference scatters wandb.log calls; this writes one JSON line an
event).  In a process group (a mesh's ranks) only rank 0 writes and
echoes: the other ranks' loggers take records and drop them."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class JsonlLogger:
    """Callable logger: appends one JSON line per event to a file (and echoes
    compact metrics to stderr).  Pass as ``log_fn`` to the trainers."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        if not is_rank0():
            path, echo = None, False
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def __call__(self, record: Dict):
        rec = {"ts": round(time.time(), 3)}
        rec.update({k: _scalar(v) for k, v in record.items()})
        if self._f:
            self._f.write(json.dumps(rec, default=str) + "\n")
            self._f.flush()
        if self.echo:
            brief = {k: v for k, v in rec.items()
                     if isinstance(v, (int, float, str)) and k != "ts"}
            print(json.dumps(brief, default=str), file=sys.stderr)

    def close(self):
        if self._f:
            self._f.close()


def is_rank0() -> bool:
    """Whether this process writes: rank 0 of its process group, or any
    process outside one."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def _scalar(v):
    try:
        import numpy as np

        if isinstance(v, (np.floating, np.integer)):
            return float(v)
    except ImportError:
        pass
    return v
