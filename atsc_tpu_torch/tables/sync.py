"""Field-sync / segment-sync symbol constants (ATSC A/53 §5.4.2).

Behavioral spec: reference src/atsc/field_sync.h — per field the encoder
writes: (1) an 820-symbol field-sync into segment 0 *and* into the padding
segment after the field (the padding feeds the RRC filter's lookahead);
(2) the 12 "reserved" symbols at the tail of segment 0 = the last 12 data
symbols of the previous field; (3) the 4-symbol segment sync {6,1,1,6} at
the head of each of the 312 data segments; fields alternate even/odd parity
(middle PN63 inverted on odd fields), starting even.

TPU-first reformulation: precompute one full (2, 261248) complex64 template
field per parity, with data-symbol slots and reserved slots zeroed, and a
boolean "is constant" mask. The runtime sync stage is then a single select
between the template and the gathered trellis symbols plus a 12-element
dynamic-slice insert — no scatters, no memcpys.
"""

from __future__ import annotations

import functools

import numpy as np

from atsc_tpu_torch import params as P
from atsc_tpu_torch.tables.lfsr import pn511, pn63
from atsc_tpu_torch.tables.trellis_tables import padded_field_gather

_FIELD_SYNC_LEN = P.SYMBOLS_PER_SEGMENT - P.RESERVED_SYMBOLS  # 820


def _xform(v: np.ndarray | int) -> np.ndarray:
    """3-bit symbol value -> signal level with pilot DC offset (signal.h:14-18)."""
    return (np.asarray(v, dtype=np.float32) * 2 - 7) + np.float32(P.PILOT_OFFSET)


def _bit_sym(bits: np.ndarray) -> np.ndarray:
    """Binary field-sync bit -> symbol value 6 (+5) or 1 (-5)."""
    return np.where(bits.astype(bool), 6, 1)


@functools.lru_cache(maxsize=1)
def field_sync_symbol_values() -> np.ndarray:
    """(2, 820) int8 field-sync 3-bit symbol values; row 0 = even field."""
    p511, p63 = pn511(), pn63()
    vsb_mode = np.array(
        [0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1, 0, 1, 0, 1, 1, 0, 1, 0],
        dtype=np.uint8,
    )
    filler = p63[np.arange(104 - P.RESERVED_SYMBOLS) % 63]

    out = np.empty((2, _FIELD_SYNC_LEN), dtype=np.int8)
    for row, even in ((0, True), (1, False)):
        mid = p63 if even else (1 - p63)  # middle PN63 inverted on odd fields
        syms = np.concatenate(
            [
                np.array([6, 1, 1, 6]),
                _bit_sym(p511),
                _bit_sym(p63),
                _bit_sym(mid),
                _bit_sym(p63),
                _bit_sym(vsb_mode),
                _bit_sym(filler),
            ]
        )
        assert syms.shape == (_FIELD_SYNC_LEN,)
        out[row] = syms
    return out


@functools.lru_cache(maxsize=1)
def field_sync_symbols() -> np.ndarray:
    """(2, 820) float32 field-sync levels; row 0 = even field, row 1 = odd."""
    return _xform(field_sync_symbol_values())


@functools.lru_cache(maxsize=1)
def segment_sync_symbols() -> np.ndarray:
    """(4,) float32 segment sync levels {6,1,1,6} (field_sync.h:30-38)."""
    return _xform(np.array([6, 1, 1, 6]))


@functools.lru_cache(maxsize=1)
def sync_templates() -> tuple[np.ndarray, np.ndarray]:
    """(template, is_const).

    template: (2, 261248) float32 — the constant (real) part of the padded
    symbol field for even/odd parity: field sync at [0,820) and at
    [260416, 261236), segment syncs at each data-segment head. All other
    slots (data symbols, reserved 12, padding tail 12) are zero.
    is_const: (261248,) bool — True where the template supplies the value.
    """
    fs = field_sync_symbols()
    seg = segment_sync_symbols()
    template = np.zeros((2, P.PADDED_SYMBOLS), dtype=np.float32)
    is_const = np.zeros(P.PADDED_SYMBOLS, dtype=bool)

    template[:, :_FIELD_SYNC_LEN] = fs
    template[:, P.SYMBOLS_PER_FIELD : P.SYMBOLS_PER_FIELD + _FIELD_SYNC_LEN] = fs
    is_const[:_FIELD_SYNC_LEN] = True
    is_const[P.SYMBOLS_PER_FIELD : P.SYMBOLS_PER_FIELD + _FIELD_SYNC_LEN] = True
    # padding tail 12 symbols: never written, stay zero (value-initialized in
    # the reference and never read by the filter) — template 0, constant.
    is_const[P.SYMBOLS_PER_FIELD + _FIELD_SYNC_LEN :] = True

    for seg_start in range(
        P.SYMBOLS_PER_SEGMENT, P.SYMBOLS_PER_FIELD, P.SYMBOLS_PER_SEGMENT
    ):
        template[:, seg_start : seg_start + 4] = seg
        is_const[seg_start : seg_start + 4] = True

    # sanity: everything that's neither const nor a data slot is the reserved 12
    is_data, _ = padded_field_gather()
    reserved = ~(is_const | is_data)
    assert reserved.sum() == P.RESERVED_SYMBOLS
    assert reserved[_FIELD_SYNC_LEN : P.SYMBOLS_PER_SEGMENT].all()
    assert not (is_const & is_data).any()
    return template, is_const


@functools.lru_cache(maxsize=1)
def sync_symbol_templates() -> tuple[np.ndarray, np.ndarray]:
    """Integer-domain twin of sync_templates for the int8 symbol pipeline.

    template: (2, 261248) int8 — 3-bit symbol values at the constant slots
    (field syncs, segment syncs); 0 elsewhere. The 12-sample padding tail at
    [261236, 261248) is symbol 0 here (the reference leaves complex zero,
    signal.h has no symbol for level 0.0) — those samples can only influence
    FIR outputs at positions >= 261125, all past the 260,416 valid outputs,
    so any value is correct; models.encoder.field_levels zeroes them when
    materializing float levels for the unfused/spec paths.
    is_const: (261248,) bool, identical to sync_templates()[1].
    """
    fs = field_sync_symbol_values()
    template = np.zeros((2, P.PADDED_SYMBOLS), dtype=np.int8)
    template[:, :_FIELD_SYNC_LEN] = fs
    template[:, P.SYMBOLS_PER_FIELD : P.SYMBOLS_PER_FIELD + _FIELD_SYNC_LEN] = fs
    seg = np.array([6, 1, 1, 6], dtype=np.int8)
    for seg_start in range(
        P.SYMBOLS_PER_SEGMENT, P.SYMBOLS_PER_FIELD, P.SYMBOLS_PER_SEGMENT
    ):
        template[:, seg_start : seg_start + 4] = seg
    _, is_const = sync_templates()
    return template, is_const


RESERVED_START = _FIELD_SYNC_LEN  # 820: where saved symbols get inserted
