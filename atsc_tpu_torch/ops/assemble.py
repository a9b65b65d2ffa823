"""Symbol assembly: output commutator + sync insertion, in the int8
3-bit-symbol domain.

Counterpart of atsc_tpu/ops/assemble.py (reference src/atsc/trellis.h:
549-576 output commutator, src/atsc/field_sync.h:12-26 sync insertion,
reserved symbols from the previous field's tail, even/odd parity). The
field stays int8 symbol values; the level map 2v - 7 + 1.25 (signal.h) is
applied where float levels are needed (field_levels, or inside the
offset+FIR kernel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.tables.sync import RESERVED_START, sync_symbol_templates


@functools.lru_cache(maxsize=1)
def _fsync() -> np.ndarray:
    """(2, 832) int8 field-sync segment per parity."""
    template, _ = sync_symbol_templates()
    return template[:, : P.SYMBOLS_PER_SEGMENT].copy()


@functools.lru_cache(maxsize=1)
def _pad() -> np.ndarray:
    """(2, 832) int8 padding segment (the FIR's lookahead) per parity."""
    template, _ = sync_symbol_templates()
    return template[:, P.SYMBOLS_PER_FIELD :].copy()


@functools.lru_cache(maxsize=1)
def _segsync() -> np.ndarray:
    return np.array([6, 1, 1, 6], dtype=np.int8)


def assemble_field_structured(
    symbols: torch.Tensor, parity: torch.Tensor, saved: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Build the padded symbol-value field.

    symbols: (B, 12, 21528) int8 trellis symbols (encoder-major);
    parity:  (B,) int32 field parity (0 even / 1 odd);
    saved:   (B, 12) int8 reserved symbols (previous field's tail).
    Returns (field (B, 261248) int8 symbol values, new_saved (B, 12) int8).

    The output commutator is block-cyclic: symbol i of data segment d comes
    from encoder (4d + i) mod 12, and each encoder gives 69 consecutive
    stream symbols per segment. With the stream viewed as (12, 312, 69)
    the commutator is a transpose to (312, 69, 12) and a roll of the
    encoder axis by 4d mod 12, which has period 3 in d: three static rolls.
    """
    b = symbols.shape[0]
    dev = symbols.device
    n_seg = P.DATA_SEGMENTS
    per_seg = P.DATA_SYMBOLS_PER_SEGMENT // P.TRELLIS_ENCODERS  # 69

    sym4 = symbols.reshape(b, P.TRELLIS_ENCODERS, n_seg, per_seg)
    t = sym4.permute(0, 2, 3, 1)                   # (B, 312, 69, 12)
    t = t.reshape(b, n_seg // 3, 3, per_seg, P.TRELLIS_ENCODERS)
    rolled = torch.stack(
        [torch.roll(t[:, :, g], -4 * g, dims=-1) for g in range(3)], dim=2
    )
    data = rolled.reshape(b, n_seg, P.DATA_SYMBOLS_PER_SEGMENT)

    par = parity.long()
    # indexing makes a fresh (B, 832) copy, so the reserved slots are
    # written in place without touching the template
    fsync = const(_fsync, dev)[par]
    fsync[:, RESERVED_START : RESERVED_START + P.RESERVED_SYMBOLS] = saved
    seg_sync = const(_segsync, dev).expand(b, n_seg, 4)
    data_segs = torch.cat([seg_sync, data], dim=-1).reshape(
        b, n_seg * P.SYMBOLS_PER_SEGMENT
    )
    field = torch.cat([fsync, data_segs, const(_pad, dev)[par]], dim=-1)
    new_saved = data[:, -1, -P.RESERVED_SYMBOLS :].clone()
    return field, new_saved


def field_levels(field: torch.Tensor) -> torch.Tensor:
    """(.., 261248) int8 symbol values -> float32 levels (signal.h xform).

    The 12-sample padding tail is 0.0 (complex zero), as in the
    reference's value-initialized buffer; no valid FIR output reads it.
    """
    lvl = field.to(torch.float32) * 2.0 + (P.PILOT_OFFSET - 7.0)
    lvl[..., P.PADDED_SYMBOLS - P.RESERVED_SYMBOLS :] = 0.0  # fresh tensor
    return lvl
