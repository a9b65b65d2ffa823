"""Roofline share (%) of the receive equalizer's fast tier, csrc/eq_fir.cu
(`eq_fir_tc_kernel<T>` in the trace): derotation, the widely linear FIR of
2K+1 taps on two planes with bf16 operands on the tensor cores, slicing.

Counted for the 260,416 outputs a channel: the window's two planes over
n + 2K samples (cs8: 1 byte a sample) and the oscillator's two float32
planes read once, the output written once (int8 symbols, or float32 soft
levels); 2 planes x (2K+1) multiply-adds an output at the bf16 peak."""

from peaks import BF16_FLOP_PER_S, bound_s, roofline_pct

KERNELS = r"eq_fir_tc_kernel"
N = 260416


def work(batch: int, eq_k: int, win_bytes: int, soft: bool) -> tuple[float, float]:
    span = N + 2 * eq_k
    nbytes = batch * 2 * span * win_bytes + 2 * span * 4 + batch * N * (4 if soft else 1)
    return nbytes, batch * N * 2 * (2 * eq_k + 1) * 2


def read(r):
    s = r.shape
    nbytes, flops = work(s["batch"], s["eq_k"], s["win_bytes"], s["soft"])
    return roofline_pct(r, KERNELS, bound_s(nbytes, flops, BF16_FLOP_PER_S))
