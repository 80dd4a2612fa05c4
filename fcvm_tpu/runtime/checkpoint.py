"""On-disk analysis checkpointing (new capability vs the reference).

The reference supports only in-session continuation through its interactive
plot loop (``source code/fcVM.py:1659-1686``); batch runs need real
state persistence.  A checkpoint stores the full per-Gauss-point state
(stress, yield stress, PEEQ, CSR), the displacement field and the load-level
history, versioned per converged step, in a single ``.npz`` per step.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def save_state(path: str, step: int, state: dict) -> str:
    """Write ``<path>/step_<n>.npz`` atomically; returns the file path."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    f = p / f"step_{step:05d}.npz"
    tmp = p / f".step_{step:05d}.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **state)
    os.replace(tmp, f)
    return str(f)


def latest_step(path: str):
    """Return (step, state dict) of the newest checkpoint, or (None, None)."""
    p = Path(path)
    if not p.is_dir():
        return None, None
    files = sorted(p.glob("step_*.npz"))
    if not files:
        return None, None
    f = files[-1]
    step = int(f.stem.split("_")[1])
    with np.load(f) as data:
        return step, {k: data[k] for k in data.files}
