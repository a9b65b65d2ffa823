"""PyTorch stage ops, each the twin of the same-named atsc_tpu.ops op.

Every op is shaped (batch, ...) over independent 8VSB channels and runs
on the device of its input; tables built by atsc_tpu_torch.tables are
copied to that device once.
"""

from atsc_tpu_torch.ops.assemble import assemble_field_structured, field_levels
from atsc_tpu_torch.ops.interleave import interleave_field_enc_major
from atsc_tpu_torch.ops.offset import advance_phasor, apply_pilot_offset
from atsc_tpu_torch.ops.randomize import randomize_field
from atsc_tpu_torch.ops.rrc_filter import rrc_filter_field
from atsc_tpu_torch.ops.rs_encode import rs_encode_field
from atsc_tpu_torch.ops.trellis import trellis_encode_field

__all__ = [
    "randomize_field",
    "rs_encode_field",
    "interleave_field_enc_major",
    "trellis_encode_field",
    "assemble_field_structured",
    "field_levels",
    "apply_pilot_offset",
    "advance_phasor",
    "rrc_filter_field",
]
