"""Root-raised-cosine pulse-shaping taps.

The shipped numeric contract is the 112-float array in reference
src/atsc/filter.h:71 (111 taps + one zero pad): alpha=0.1152, 2
samples/symbol (symbol rate = fs/2, the VSB Nyquist shaping), DC gain 0.1.
We derive the taps independently from the textbook RRC impulse response

    h(t) = [sin(pi t (1-a)) + 4 a t cos(pi t (1+a))] / [pi t (1 - (4 a t)^2)]

(t in symbol periods), normalized to sum (DC gain) = GAIN, and verify —
inside rrc_taps(), i.e. before any tap can ever be used — that the
derivation reproduces the shipped float32 contract
(spec/shipped_rrc.py, transcribed from reference filter.h:71) to within
1 ulp per tap; a mismatch would silently break IQ compatibility with
deployed receivers. tests/test_stages.py::test_rrc_taps_shipped_contract
additionally pins the exact ulp budget.
"""

from __future__ import annotations

import functools

import numpy as np

from atsc_tpu_torch import params as P

_SPB = 2.0  # samples per symbol: SAMPLE_RATE / (SAMPLE_RATE / 2)


@functools.lru_cache(maxsize=1)
def rrc_taps() -> np.ndarray:
    """(112,) float32 taps: 111 RRC taps + trailing zero pad."""
    a = P.RRC_ALPHA
    n = P.RRC_NTAPS
    k = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    t = k / _SPB

    h = np.empty(n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        num = np.sin(np.pi * t * (1 - a)) + 4 * a * t * np.cos(np.pi * t * (1 + a))
        den = np.pi * t * (1 - (4 * a * t) ** 2)
        h = num / den
    # t = 0 singularity
    h[np.isclose(t, 0)] = 1 - a + 4 * a / np.pi
    # |4 a t| = 1 singularity
    sing = np.isclose(np.abs(4 * a * t), 1)
    h[sing] = (a / np.sqrt(2)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * a))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * a))
    )

    h *= P.RRC_GAIN / h.sum()
    out = np.zeros(P.RRC_TAPS, dtype=np.float32)
    out[: n] = h.astype(np.float32)

    # guard the shipped contract: 1-ulp-per-tap tolerance (the float64
    # derivation rounds a handful of taps one ulp away from the reference's
    # printed float32 literals; anything larger is a real drift)
    from atsc_tpu_torch.spec.shipped_rrc import SHIPPED_RRC_TAPS

    tol = np.spacing(np.abs(SHIPPED_RRC_TAPS).astype(np.float32))
    if not np.all(np.abs(out - SHIPPED_RRC_TAPS) <= tol):
        worst = np.abs(out - SHIPPED_RRC_TAPS).max()
        raise AssertionError(
            f"derived RRC taps drifted from the shipped contract "
            f"(filter.h:71): max |delta| = {worst:.3e}"
        )
    return out


def rrc_filter_field_np(padded: np.ndarray) -> np.ndarray:
    """Numpy oracle: forward FIR out[i] = sum_k in[i+k] c[k] over the padded
    field (reference filter.h:9-14), float64 accumulation."""
    taps = rrc_taps().astype(np.float64)
    out = np.zeros(P.SYMBOLS_PER_FIELD, dtype=np.complex128)
    for kidx in range(P.RRC_NTAPS):
        if taps[kidx] != 0.0:
            out += taps[kidx] * padded[kidx : kidx + P.SYMBOLS_PER_FIELD]
    return out.astype(np.complex64)
