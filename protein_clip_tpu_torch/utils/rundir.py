"""Run-directory contract: ``runs/<YYYYMMDD_HHMMSS_us>/`` (the port of
``protein_clip_tpu/utils/rundir.py``)."""

from __future__ import annotations

import os
from datetime import datetime
from pathlib import Path


def make_run_dir(root: str | Path | None = None) -> Path:
    root = Path(root) if root is not None else Path(os.getcwd()) / "runs"
    run_dir = root / datetime.now().strftime("%Y%m%d_%H%M%S_%f")
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir
