"""Constants and host tables of ATSC A/53 Part 2 8-VSB, built in NumPy.

The numerology (A/53 Part 2 section 5) and the tables the transmitter needs:
the data randomizer's PN bytes, RS(207,187) as a GF(2) bit matrix, the
52-branch convolutional interleaver fused with the trellis commutator as a
gather, the field and segment sync symbols, the pilot-offset oscillator with
its float32 argument rounding, and the root-raised-cosine taps.
"""

from __future__ import annotations

import functools

import numpy as np

# --- geometry -----------------------------------------------------------------
SEGMENTS = 313
DATA_SEGMENTS = 312
MPEG2_BYTES = 188
SEGMENT_BYTES = 187
RS_BYTES = 20
FEC_BYTES = SEGMENT_BYTES + RS_BYTES                  # 207
SYMBOLS_PER_SEGMENT = 832
DATA_SYMBOLS_PER_SEGMENT = FEC_BYTES * 4              # 828
DATA_PER_FIELD = FEC_BYTES * DATA_SEGMENTS            # 64,584
N = SYMBOLS_PER_SEGMENT * SEGMENTS                    # 260,416 symbols a field
PADDED = N + SYMBOLS_PER_SEGMENT                      # 261,248
FIELD_TS_BYTES = DATA_SEGMENTS * MPEG2_BYTES          # 58,656
RESERVED = 12
RESERVED_START = SYMBOLS_PER_SEGMENT - RESERVED       # 820
ENCODERS = 12
ENC_BYTES = 13
ROUNDS = DATA_PER_FIELD // (ENCODERS * ENC_BYTES)     # 414
BYTES_PER_ENCODER = ROUNDS * ENC_BYTES                # 5,382
SYMBOLS_PER_ENCODER = BYTES_PER_ENCODER * 4           # 21,528

# --- rates and signal -------------------------------------------------------------
SAMPLE_RATE = 4_500_000.0 / 286.0 * 684.0             # 10.762 Msym/s
FIELD_RATE = SAMPLE_RATE / N                          # 41.327 fields/s
PILOT = 1.25
OSC_FREQUENCY = 309_411.0 - 3_000_000.0
OSC_AMPLITUDE = 0.9
RRC_ALPHA, RRC_GAIN, RRC_NTAPS = 0.1152, 0.1, 111
CS8_QMAX = 127


@functools.lru_cache(maxsize=1)
def randomizer_table() -> np.ndarray:
    """(312, 187) uint8: the 16-bit LFSR (generator 0x9c65, state 0xf180 at
    each field start), sampled before each advance."""
    n = SEGMENT_BYTES * DATA_SEGMENTS
    out = np.empty(n, np.uint8)
    state = 0xF180
    for i in range(n):
        out[i] = (((state & 0x3C00) >> 6) | ((state & 0x0040) >> 3)
                  | ((state & 0x000C) >> 1) | (state & 0x0001))
        state <<= 1
        if state & 0x10000:
            state ^= (0x9C65 << 1) | 1
    return out.reshape(DATA_SEGMENTS, SEGMENT_BYTES)


@functools.lru_cache(maxsize=1)
def _gf() -> tuple[np.ndarray, np.ndarray]:
    """(exp (512,), log (256,)) of GF(256) over x^8+x^4+x^3+x^2+1."""
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    v = 1
    for i in range(255):
        exp[i] = exp[i + 255] = v
        log[v] = i
        v <<= 1
        if v & 0x100:
            v ^= 0x11D
    return exp, log


def _gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    exp, log = _gf()
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return np.where((a == 0) | (b == 0), 0, exp[log[a] + log[b]])


@functools.lru_cache(maxsize=1)
def rs_generator() -> np.ndarray:
    """(21,) generator coefficients, g[i] of x^i, roots alpha^0..alpha^19."""
    exp, _ = _gf()
    g = np.zeros(RS_BYTES + 1, np.int64)
    g[0] = 1
    for root in range(RS_BYTES):
        nxt = np.zeros_like(g)
        nxt[1:root + 2] = g[:root + 1]
        nxt[:root + 1] ^= _gf_mul(g[:root + 1], exp[root])
        g = nxt
    return g


def rs_parity(data: np.ndarray) -> np.ndarray:
    """(n, 187) data bytes -> (n, 20) parity bytes by LFSR division, the
    systematic RS(207,187) shortened from RS(255,235)."""
    g_rev = rs_generator()[:RS_BYTES][::-1]
    reg = np.zeros((data.shape[0], RS_BYTES), np.int64)
    for col in range(data.shape[1]):
        fb = data[:, col].astype(np.int64) ^ reg[:, 0]
        reg = np.concatenate([reg[:, 1:], np.zeros_like(reg[:, :1])], axis=1)
        reg ^= _gf_mul(fb[:, None], g_rev[None, :])
    return reg.astype(np.uint8)


@functools.lru_cache(maxsize=1)
def rs_bit_matrix() -> np.ndarray:
    """(1496, 160) float32 of 0/1: parity bits = data bits @ M mod 2, bits
    MSB first (the code is linear over GF(2))."""
    basis = np.zeros((SEGMENT_BYTES * 8, SEGMENT_BYTES), np.uint8)
    for j in range(SEGMENT_BYTES * 8):
        basis[j, j // 8] = 1 << (7 - j % 8)
    return np.unpackbits(rs_parity(basis), axis=1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def interleave_gather() -> np.ndarray:
    """(64584,) int64 index into concat(current RS field, previous RS field)
    of every output byte, in encoder-major order (encoder, round, byte):
    the 52-branch, 4-byte convolutional interleaver with the trellis
    commutator's rotation at segment boundaries and the 12-encoder
    transpose, inverted from its scatter form."""
    group = ENC_BYTES * ENCODERS
    bounds = [((FEC_BYTES * i + ENCODERS - 1) // ENCODERS) * ENCODERS
              for i in range(DATA_SEGMENTS * 3)]
    it = iter(bounds[1:])
    next_b = next(it)
    shift = 0
    dest = np.zeros(DATA_PER_FIELD, np.int64)
    fifo = [np.full(4 * k, -1, np.int64) for k in range(52)]
    head = [0] * 52
    line = 0
    for pos in range(DATA_PER_FIELD * 2):
        if pos == next_b:
            next_b = next(it)
            shift = (shift + 4) % ENCODERS
        grp, rem = divmod(pos, group)
        d = grp * group + ((pos + shift) % ENCODERS) * ENC_BYTES + rem // ENCODERS
        d = d - DATA_PER_FIELD + (1 << 20) if d >= DATA_PER_FIELD else d
        if line == 0:
            if pos < DATA_PER_FIELD:
                dest[pos] = d
        else:
            src = fifo[line][head[line]]
            fifo[line][head[line]] = pos
            if 0 <= src < DATA_PER_FIELD:
                dest[src] = d
            head[line] = (head[line] + 1) % (4 * line)
        line = 0 if line == 51 or pos == DATA_PER_FIELD - 1 else line + 1
    to_next = dest >> 20
    where = dest & ((1 << 20) - 1)
    src = np.empty(DATA_PER_FIELD, np.int64)
    src[where] = np.arange(DATA_PER_FIELD) + DATA_PER_FIELD * to_next
    # round-major (round, encoder, byte) -> encoder-major (encoder, round, byte)
    return np.ascontiguousarray(
        src.reshape(ROUNDS, ENCODERS, ENC_BYTES).transpose(1, 0, 2)).reshape(-1)


def _lfsr(state: int, shift_out: int, mask: int, n: int) -> np.ndarray:
    out = np.empty(n, np.int8)
    for i in range(n):
        out[i] = (state >> shift_out) & 1
        state = ((state << 1) | (bin(state & mask).count("1") & 1)) & 0xFFFFFFFF
    return out


@functools.lru_cache(maxsize=1)
def field_sync() -> np.ndarray:
    """(2, 820) int8 symbol values of the field sync, even and odd field
    (the middle PN63 inverted on odd fields)."""
    p511 = _lfsr(0b10, 8, 0b110110110, 511)
    p63 = _lfsr(0b111001, 5, 0b110000, 63)
    mode = np.array([0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1, 0, 1, 0, 1,
                     1, 0, 1, 0], np.int8)
    filler = p63[np.arange(104 - RESERVED) % 63]
    out = np.empty((2, RESERVED_START), np.int8)
    for row, mid in ((0, p63), (1, 1 - p63)):
        bits = np.concatenate([p511, p63, mid, p63, mode, filler])
        out[row] = np.concatenate([[6, 1, 1, 6], np.where(bits == 1, 6, 1)])
    return out


def osc_phase_increment() -> float:
    return 2.0 * np.pi * OSC_FREQUENCY / SAMPLE_RATE


@functools.lru_cache(maxsize=1)
def oscillator() -> np.ndarray:
    """(2, 261248) float32 (re, im) of field 0's oscillator: 0.9 e^{j w n},
    with the argument rounded to float32 before cos and sin."""
    n = np.arange(PADDED, dtype=np.float64)
    arg = (osc_phase_increment() * n).astype(np.float32).astype(np.float64)
    return np.stack([OSC_AMPLITUDE * np.cos(arg),
                     OSC_AMPLITUDE * np.sin(arg)]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def field_advance() -> np.ndarray:
    """(2,) float32 (re, im) of the per-field phase advance, argument
    rounded to float32."""
    arg = np.float64(np.float32(osc_phase_increment() * N))
    return np.array([np.cos(arg), np.sin(arg)]).astype(np.float32)


def phasor_sequence(n_fields: int) -> np.ndarray:
    """(n_fields, 2) float32 phasor of fields 0..n-1: the float32 complex
    recurrence z <- z * advance, each product and sum rounded."""
    sr, si = (np.float32(v) for v in field_advance())
    out = np.empty((n_fields, 2), np.float32)
    re, im = np.float32(1.0), np.float32(0.0)
    for k in range(n_fields):
        out[k] = re, im
        re, im = (np.float32(np.float32(re * sr) - np.float32(im * si)),
                  np.float32(np.float32(re * si) + np.float32(im * sr)))
    return out


@functools.lru_cache(maxsize=1)
def rrc_taps() -> np.ndarray:
    """(111,) float32 root-raised-cosine taps, alpha 0.1152, 2 samples a
    symbol, DC gain 0.1, applied as out[i] = sum_k in[i+k] c[k]."""
    a = RRC_ALPHA
    t = (np.arange(RRC_NTAPS, dtype=np.float64) - (RRC_NTAPS - 1) / 2) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        h = ((np.sin(np.pi * t * (1 - a)) + 4 * a * t * np.cos(np.pi * t * (1 + a)))
             / (np.pi * t * (1 - (4 * a * t) ** 2)))
    h[np.isclose(t, 0)] = 1 - a + 4 * a / np.pi
    h[np.isclose(np.abs(4 * a * t), 1)] = (a / np.sqrt(2)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * a)) + (1 - 2 / np.pi) * np.cos(np.pi / (4 * a)))
    return (h * (RRC_GAIN / h.sum())).astype(np.float32)


@functools.lru_cache(maxsize=1)
def cs8_scale() -> np.float32:
    """The float32 multiplier from IQ to cs8 codes: 127 over the analytic
    worst-case |I| (|phasor| slack 1e-4, 0.9, the top level 8.25, and the
    taps' L1 norm), so no field clips."""
    shipped = np.concatenate([rrc_taps(), np.zeros(1, np.float32)])  # 111 + a zero pad
    peak = (1.0 + 1e-4) * OSC_AMPLITUDE * 8.25 * float(np.abs(shipped).sum())
    return np.float32(CS8_QMAX / peak)
