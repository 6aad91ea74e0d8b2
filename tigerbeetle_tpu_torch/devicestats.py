"""Per-kernel call-shape registry (slim copy of the reference package's
devicestats.py: the two calls the state machine makes).

`note_call` records the argument shapes of each kernel-entry call while
the tracer is enabled; `retire_bucket` drops the rows of a scratch-ring
bucket the workload stopped using, so the registry stays bounded. The
reference's compiler cost model has no counterpart here: a hand-written
kernel's bytes and operations are stated beside it (ops/commit.py).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from tigerbeetle_tpu_torch import tracer

_lock = threading.Lock()
_shapes: Dict[str, Dict[str, Optional[int]]] = {}
_SHAPES_PER_ENTRY_MAX = 16  # bucket shapes are power-of-two padded: few


def _spec_key(args) -> str:
    """"8192x4:torch.uint32|8192:torch.int32"-style key over the array
    leaves of the arguments (NamedTuples and sequences recurse)."""
    parts = []

    def walk(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            parts.append("x".join(str(int(d)) for d in x.shape) + f":{x.dtype}")
        elif isinstance(x, (tuple, list)):
            for f in x:
                walk(f)
        else:
            parts.append(f"={x!r}")

    walk(args)
    return "|".join(parts)


def note_call(entry: str, args: tuple, bucket: Optional[int] = None) -> None:
    """Record one kernel-entry call's argument shapes (metadata reads
    only — never a device sync). `bucket` tags the row with its
    scratch-ring pad size."""
    if not tracer.enabled():
        return
    key = _spec_key(args)
    with _lock:
        rows = _shapes.setdefault(entry, {})
        if key in rows or len(rows) < _SHAPES_PER_ENTRY_MAX:
            rows[key] = bucket


def retire_bucket(bucket: int) -> None:
    """Drop every shape row tagged with a retired scratch-ring bucket."""
    with _lock:
        for entry, rows in list(_shapes.items()):
            for k in [k for k, b in rows.items() if b == bucket]:
                del rows[k]
            if not rows:
                del _shapes[entry]


def observed_shapes() -> Dict[str, list]:
    with _lock:
        return {e: sorted(rows) for e, rows in _shapes.items()}

