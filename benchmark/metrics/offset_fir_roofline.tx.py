"""Roofline share (%) of the transmit kernel, csrc/offset_fir.cu
(`offset_fir_kernel<F>` in the trace): level map, pilot offset and the
111-tap root-raised-cosine FIR of B channels, then the output format.

Counted for the 260,416 valid outputs a channel: each reads 111 symbols
(the span read once), the oscillator's two planes over the span, the
phasor; 2 planes x 111 multiply-adds a sample in float32; the output
written once (cs8 wire lanes 2 bytes a sample, cf32 8)."""

from peaks import FP32_FLOP_PER_S, bound_s, roofline_pct

KERNELS = r"offset_fir_kernel"
N, TAPS = 260416, 111
OUT_BYTES = {("cs8", True): 2, ("cf32", False): 8}


def work(batch: int, out_format: str, wire: bool) -> tuple[float, float]:
    """(bytes, flops) of one launch."""
    span = N + TAPS - 1
    nbytes = batch * span + 2 * 4 * span + batch * 2 * 4 + batch * N * OUT_BYTES[
        (out_format, wire)]
    return nbytes, batch * N * 2 * TAPS * 2


def read(r):
    s = r.shape
    nbytes, flops = work(s["batch"], s["out_format"], s["wire"])
    return roofline_pct(r, KERNELS, bound_s(nbytes, flops, FP32_FLOP_PER_S))
