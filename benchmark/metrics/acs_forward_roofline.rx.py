"""Roofline share (%) of the 4-state Viterbi forward pass,
csrc/viterbi_acs.cu (`acs_forward_kernel<float>` in the trace; not the
PR or chunked forms): T = 21,528 steps over L = 12 B lanes.

Counted: float32 observations read once (T L x 4 bytes), the decision
words written once (T/4 L x 4), metrics in and out (2 x 4 L x 4); 32
float32 operations a step and lane (8 sub, 8 mul, 4 min, 8 add, 4
select)."""

from peaks import FP32_FLOP_PER_S, bound_s, roofline_pct

KERNELS = r"(?<![A-Za-z_])acs_forward_kernel"
T = 21528


def work(batch: int) -> tuple[float, float]:
    lanes = 12 * batch
    return T * lanes * 4 + (T // 4) * lanes * 4 + 2 * 4 * lanes * 4, T * lanes * 32


def read(r):
    nbytes, flops = work(r.shape["batch"])
    return roofline_pct(r, KERNELS, bound_s(nbytes, flops, FP32_FLOP_PER_S))
