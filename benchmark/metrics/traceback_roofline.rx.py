"""Roofline share (%) of the 4-state Viterbi traceback, csrc/viterbi_acs.cu
(`traceback_kernel` in the trace; not `pr_traceback_kernel` or the chunked
form): the decision words (T/4 L x 4 bytes) read once, the bit words
(T/4 L x 4) written once, the start states (L x 4) read; no arithmetic
counted."""

from peaks import FP32_FLOP_PER_S, bound_s, roofline_pct

KERNELS = r"(?<![A-Za-z_])traceback_kernel"
T = 21528


def work(batch: int) -> tuple[float, float]:
    lanes = 12 * batch
    return 2 * (T // 4) * lanes * 4 + lanes * 4, 0.0


def read(r):
    nbytes, flops = work(r.shape["batch"])
    return roofline_pct(r, KERNELS, bound_s(nbytes, flops, FP32_FLOP_PER_S))
