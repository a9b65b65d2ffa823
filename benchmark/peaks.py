"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W), and the roofline bound of a kernel call."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12       # CUDA cores
BF16_FLOP_PER_S = 989e12      # tensor cores
TF32_FLOP_PER_S = 494.7e12    # tensor cores


def bound_s(nbytes: float, flops: float, flop_rate: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def roofline_pct(reading, pattern: str, bound: float):
    """100 x (bound x launches) / (traced kernel time) of the kernels whose
    name matches `pattern`; None where the trace holds none."""
    times = reading.trace.kernel_times(pattern) if reading.trace is not None else []
    if not times or sum(times) <= 0:
        return None
    return 100.0 * bound * len(times) / sum(times)
