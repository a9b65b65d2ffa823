"""Device copies of the host-built tables every op closes over."""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def const(make: Callable[[], np.ndarray], device: torch.device) -> torch.Tensor:
    """`make()` (a cached numpy table) as a tensor on `device`, made once
    per (table, device). A copy, so no caller can write into the numpy
    original; no op writes into the tensor either."""
    return torch.tensor(np.ascontiguousarray(make()), device=device)
