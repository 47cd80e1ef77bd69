"""Device labels for per-device pools, the part of
``repro.solver.placement`` that the streaming service needs.

Multi-device placement (meshes, sharded ``run_batch``, padding a batch to
the devices) is not ported yet (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import Optional

import torch


def device_label(device: Optional[torch.device], index: int) -> str:
    """Stable human-readable label for one device position: the Chrome
    trace *process* name of that device's streaming pools and the
    ``device`` field of request-scoped lifecycle events.  ``device=None``
    (the single-device route) stays the bare ``dev<i>``."""
    if device is None:
        return f"dev{index}"
    return f"dev{index}:{device.type}{device.index or 0}"
