"""atsc_tpu_torch — the ATSC 8VSB modulator in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

The twin of the JAX package `atsc_tpu`, which stays the reference: the
same public names, layouts and dtypes, held against it by the tests. This
package imports neither JAX nor anything of `atsc_tpu`. It keeps its own
copy of the host-side contract: `params`, `tables/`, the shipped RRC taps
(`spec/shipped_rrc.py`) and the IO runtime (`runtime/io.py`,
`csrc/tsio.cpp`); tests/test_torch_isolation.py holds each copy equal to
the reference and proves the isolation.

Device rule: a CUDA tensor goes through the hand kernel, a CPU tensor
through the kernel's plain PyTorch twin. There is no switch and no
fallback: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch.device for `device` ("cpu", "cuda", "cuda:1", ...).

    "cuda" resolves to the current CUDA device with its index. Asking for
    CUDA on a machine without it raises; it never quietly gives the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available()"
                " is False (no CUDA device or a CPU-only PyTorch build)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev
