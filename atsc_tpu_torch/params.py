"""ATSC 8VSB numerology — the frozen constants every component shares.

These mirror the normative constants of ATSC A/53 Part 2 as used by the
reference implementation (reference: src/common/atsc_parameters.h:5-29).
The port's own copy of atsc_tpu/params.py, value for value (held equal by
tests/test_torch_isolation.py); every shape in the port follows from it.
"""

from __future__ import annotations

# --- segment / field geometry -------------------------------------------------
SEGMENTS_PER_FIELD = 313          # 1 field-sync segment + 312 data segments
DATA_SEGMENTS = 312
MPEG2_BYTES = 188                 # transport stream packet size
SEGMENT_BYTES = 187               # payload bytes per segment (0x47 sync dropped)
RS_BYTES = 20                     # Reed-Solomon parity bytes per segment
SEGMENT_FEC_BYTES = SEGMENT_BYTES + RS_BYTES          # 207 = RS(207,187) codeword
SYMBOLS_PER_BYTE = 4              # 8VSB: 2 bits/symbol
SYMBOLS_PER_SEGMENT = (SEGMENT_FEC_BYTES + 1) * SYMBOLS_PER_BYTE   # 832
DATA_SYMBOLS_PER_SEGMENT = SEGMENT_FEC_BYTES * SYMBOLS_PER_BYTE    # 828
DATA_PER_FIELD = SEGMENT_FEC_BYTES * DATA_SEGMENTS                 # 64,584
DATA_SYMBOLS_PER_FIELD = DATA_SYMBOLS_PER_SEGMENT * DATA_SEGMENTS  # 258,336
SYMBOLS_PER_FIELD = SYMBOLS_PER_SEGMENT * SEGMENTS_PER_FIELD       # 260,416
RESERVED_SYMBOLS = 12             # reserved tail of the field-sync segment

# --- trellis ------------------------------------------------------------------
TRELLIS_ENCODERS = 12
TRELLIS_INPUT_BYTES = 13          # contiguous bytes per encoder per round
TRELLIS_ROUND_BYTES = TRELLIS_ENCODERS * TRELLIS_INPUT_BYTES       # 156
TRELLIS_ROUNDS = DATA_PER_FIELD // TRELLIS_ROUND_BYTES             # 414
TRELLIS_BYTES_PER_ENCODER = TRELLIS_ROUNDS * TRELLIS_INPUT_BYTES   # 5,382
TRELLIS_SYMBOLS_PER_ENCODER = TRELLIS_BYTES_PER_ENCODER * SYMBOLS_PER_BYTE  # 21,528

# --- I/O geometry ---------------------------------------------------------------
FIELD_TS_BYTES = DATA_SEGMENTS * MPEG2_BYTES                       # 58,656
PADDED_SYMBOLS = SYMBOLS_PER_FIELD + SYMBOLS_PER_SEGMENT           # 261,248
# One extra segment of padding after the field, consumed by the RRC filter's
# forward lookahead (reference: src/atsc/filter.h:9-14).
RRC_TAPS = 112                    # 111 real taps + 1 zero pad
RRC_LOOKAHEAD = RRC_TAPS - 1      # forward-only FIR: out[i] = sum in[i+k] c[k]

# Device-side IQ output is planar (re, im) and padded to whole 128-sample
# blocks so the MXU-banded FIR writes straight to its destination with no
# trailing slice/transpose pass: (B, 2, PADDED_OUT) with samples
# [0, SYMBOLS_PER_FIELD) valid. Interleaving to the reference's CF32 layout
# happens at the host boundary (models.encoder.iq_interleave).
# rounded to 1,024 (8 x 128-lane blocks) so kernel output chunks can tile
# the row axis in 8-row multiples (a Mosaic block-shape requirement)
PADDED_OUT = -(-SYMBOLS_PER_FIELD // 1024) * 1024                  # 261,120

# --- rates ----------------------------------------------------------------------
SAMPLE_RATE = 4_500_000.0 / 286.0 * 684.0        # 10,762,237.76… Hz symbol rate
FIELD_RATE = SAMPLE_RATE / SYMBOLS_PER_FIELD     # ≈ 41.327 fields/s
TS_BITRATE = FIELD_TS_BYTES * 8 * FIELD_RATE     # ≈ 19.3927 Mbps payload

# --- signal mapping ---------------------------------------------------------------
# 3-bit symbol v in [0,8) maps to level (2v-7) + PILOT (reference: src/atsc/signal.h)
PILOT_OFFSET = 1.25

# --- pilot / frequency offset (reference: src/atsc/offset.h:84-87) ---------------
OSC_FREQUENCY = 309_411.0 - 3_000_000.0          # Hz (note: 309411, not A/53 nominal)
OSC_AMPLITUDE = 0.9

# --- RRC filter design (reference: src/common/filter.h / src/atsc/filter.h) ------
RRC_ALPHA = 0.1152
RRC_GAIN = 0.1
RRC_NTAPS = 111
