"""Field-stream time-block sharding: encode T = n_time * F consecutive
fields per channel in one step, fields distributed over the "time" mesh
axis, channels over "ch".

Counterpart of atsc_tpu/parallel/field_shard.py. After symbol generation
the fields are embarrassingly parallel (the padded field-sync tail
supplies the RRC lookahead), and every cross-field dependency is O(1)
state that is either closed-form in the field index (sync parity,
oscillator phasor) or XOR-linear in the data (trellis carries: prefix-XOR
of per-field parities) or a single field buffer (interleaver double
buffer, reserved symbols). A step therefore needs only:

  * one ring-permute of each shard's last RS field to its right neighbour
    (the interleaver's cross-field input),
  * one all-gather of per-shard 36-bit trellis parity totals and an
    exclusive XOR scan across the time axis,
  * one ring-permute of 12 boundary symbols (reserved-symbol tails),
  * at the end, the last time shard's RS field and tails copied to every
    time shard (the next step's state, replicated over time).

Each shard's back half (level map + pilot offset + RRC FIR + quantiser) is
one launch of the offset_fir_fused hand kernel over its F*b fields, the
sequential encoder's kernel. The results equal the sequential encoder's
bit for bit: IQ and every state leaf.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.models.encoder import EncoderState, init_state
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.ops.assemble import assemble_field_structured
from atsc_tpu_torch.ops.cuda.offset_fir import offset_fir_fused
from atsc_tpu_torch.ops.interleave import interleave_field_enc_major
from atsc_tpu_torch.ops.offset import advance_phasor
from atsc_tpu_torch.ops.randomize import randomize_field
from atsc_tpu_torch.ops.rs_encode import rs_encode_field
from atsc_tpu_torch.ops.trellis import trellis_encode_field
from atsc_tpu_torch.parallel.collectives import all_gather, broadcast_last, ring_permute
from atsc_tpu_torch.parallel.distributed import put_global
from atsc_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh, gather

#: placement of the carried state: channels over "ch", replicated over time
STATE_SPEC = EncoderState(
    prev_rs=(CH_AXIS, None), trellis_d=(CH_AXIS, None), trellis_d1=(CH_AXIS, None),
    trellis_d2=(CH_AXIS, None), saved=(CH_AXIS, None), parity=(CH_AXIS,),
    phasor=(CH_AXIS, None),
)
TS_SPEC = (TIME_AXIS, CH_AXIS, None)
IQ_SPEC = (TIME_AXIS, CH_AXIS, None, None)


@functools.lru_cache(maxsize=1)
def _tail_encoders() -> np.ndarray:
    """The encoder of each of a field's last 12 data symbols (the next
    field's reserved symbols): they are the last symbols of the 12
    encoder streams, in the commutator's order for the field's last
    segment (ops/assemble.py: segment d rolls the encoders by 4d mod 12)."""
    roll = 4 * ((P.DATA_SEGMENTS - 1) % 3)
    return (np.arange(P.TRELLIS_ENCODERS) + roll) % P.TRELLIS_ENCODERS


@functools.lru_cache(maxsize=1)
def _even_pos() -> np.ndarray:
    """(21528,) int8: 1 at even bit-pair positions (z0's d1 chain), 0 at odd."""
    pat = np.zeros(P.TRELLIS_SYMBOLS_PER_ENCODER, dtype=np.int8)
    pat[0::2] = 1
    return pat


def _phasor_chain(phasor0: torch.Tensor, t_total: int) -> list[torch.Tensor]:
    """The per-field phasors of a step: element g is the phasor of global
    field g, before its advance. Replays ops/offset.py advance_phasor, so
    it is the sequential encoder's float32 recurrence bit for bit."""
    chain = [phasor0]
    for _ in range(t_total - 1):
        chain.append(advance_phasor(chain[-1]))
    return chain


def _fec(ts: torch.Tensor) -> torch.Tensor:
    """(F, b, 58656) uint8 -> (F, b, 64584) RS-encoded fields."""
    f, b = ts.shape[:2]
    rs = rs_encode_field(randomize_field(ts.reshape(f * b, P.FIELD_TS_BYTES)))
    return rs.reshape(f, b, P.DATA_PER_FIELD)


def _local_trellis(rs_flat: torch.Tensor, incoming_rs: torch.Tensor):
    """Interleave with the previous fields and trellis-encode every local
    field from zero carries. Returns (symbols (F, b, 12, 21528) int8,
    exclusive local XOR prefix of the carries (F, 3, b, 12), their total
    over the F fields (3, b, 12))."""
    f, b = rs_flat.shape[:2]
    prev = torch.cat([incoming_rs[None], rs_flat[:-1]])
    il = interleave_field_enc_major(rs_flat.reshape(f * b, -1), prev.reshape(f * b, -1))
    zeros = torch.zeros((f * b, P.TRELLIS_ENCODERS), dtype=torch.int32, device=il.device)
    sym, dd, dd1, dd2 = trellis_encode_field(il, zeros, zeros, zeros)
    deltas = torch.stack([dd, dd1, dd2]).reshape(3, f, b, -1).transpose(0, 1)
    incl = torch.cumsum(deltas, dim=0, dtype=torch.int32)
    return (sym.reshape(f, b, P.TRELLIS_ENCODERS, -1), (incl - deltas) & 1,
            incl[-1] & 1)


def _apply_carries(sym: torch.Tensor, carries: torch.Tensor) -> torch.Tensor:
    """XOR the true trellis carries into zero-carry symbols: z2 toggles
    symbol bit 2; z0 toggles bit 0, with the d1 carry on even bit-pair
    positions and the d2 carry on odd ones. carries (F, 3, b, 12)."""
    even = const(_even_pos, sym.device)
    c = carries.to(torch.int8)[..., None]               # (F, 3, b, 12, 1)
    mask = c[:, 0] * 4 + c[:, 1] * even + c[:, 2] * (1 - even)
    return sym ^ mask


def _step(mesh: Mesh, state: dict, ts: dict, f_dev: int, out_format: str):
    """One sharded step, phase by phase over this process's shards.
    state {coord: EncoderState (b, ...)}; ts {coord: (F, b, 58656)}.
    Returns (new state, {coord: (F, b, 2, 261120) IQ})."""
    n_time = mesh.shape[TIME_AXIS]
    t_total = f_dev * n_time
    local = list(ts)
    rs_flat = {c: _fec(ts[c]) for c in local}

    # interleaver: field 0 of a shard needs its left neighbour's last field
    rs_left = ring_permute(mesh, {c: rs_flat[c][-1] for c in local}, TIME_AXIS)
    sym, excl, total = {}, {}, {}
    for c in local:
        incoming = state[c].prev_rs if c[0] == 0 else rs_left[c]
        sym[c], excl[c], total[c] = _local_trellis(rs_flat[c], incoming)

    # trellis carries: exclusive XOR scan across the time shards
    gathered = all_gather(mesh, total, TIME_AXIS)       # (n_time, 3, b, 12)
    symbols, tails, new_trellis = {}, {}, {}
    for c in local:
        st = state[c]
        carry0 = torch.stack([st.trellis_d, st.trellis_d1, st.trellis_d2])
        prefix = gathered[c][: c[0]].sum(dim=0, dtype=torch.int32)
        symbols[c] = _apply_carries(sym[c], (excl[c] + prefix + carry0) & 1)
        new_trellis[c] = (carry0 + gathered[c].sum(dim=0, dtype=torch.int32)) & 1
        tail_enc = const(_tail_encoders, symbols[c].device)
        tails[c] = symbols[c][:, :, tail_enc, -1]       # (F, b, 12) int8

    # reserved symbols: field 0 of a shard takes its left neighbour's tail
    tail_left = ring_permute(mesh, {c: tails[c][-1] for c in local}, TIME_AXIS)
    iq, last_phasor = {}, {}
    for c in local:
        st = state[c]
        f, b = symbols[c].shape[:2]
        incoming = st.saved if c[0] == 0 else tail_left[c]
        saved = torch.cat([incoming[None], tails[c][:-1]])
        g0 = c[0] * f_dev
        local_g = torch.arange(g0, g0 + f, dtype=torch.int32, device=st.parity.device)
        parity = (st.parity[None, :] + local_g[:, None]) & 1
        chain = _phasor_chain(st.phasor, t_total)
        last_phasor[c] = chain[-1]
        phasors = torch.stack(chain[g0 : g0 + f])
        field, _ = assemble_field_structured(
            symbols[c].reshape(f * b, P.TRELLIS_ENCODERS, -1), parity.reshape(f * b),
            saved.reshape(f * b, -1))
        out = offset_fir_fused(field, phasors.reshape(f * b, 2).contiguous(),
                               out_format=out_format)
        iq[c] = out.reshape(f, b, 2, out.shape[-1])

    # next state: the last time shard's, replicated over time
    prev_rs = broadcast_last(mesh, {c: rs_flat[c][-1] for c in local}, TIME_AXIS)
    saved_next = broadcast_last(mesh, {c: tails[c][-1] for c in local}, TIME_AXIS)
    new_state = {}
    for c in local:
        st = state[c]
        new_state[c] = EncoderState(
            prev_rs=prev_rs[c], trellis_d=new_trellis[c][0],
            trellis_d1=new_trellis[c][1], trellis_d2=new_trellis[c][2],
            saved=saved_next[c], parity=(st.parity + t_total) & 1,
            phasor=advance_phasor(last_phasor[c]))
    return new_state, iq


class ShardedEncoder:
    """Multi-device encoder over a ("time", "ch") mesh.

    Encodes T = n_time * fields_per_device consecutive fields for B
    channels per step; B must be divisible by n_ch. Results equal the
    sequential encoder's exactly. A state or step input is either a full
    array (placed here) or the dict of this process's shards that
    put_global returns (what a multi-process driver passes).
    """

    def __init__(self, mesh: Mesh, batch: int, fields_per_device: int = 1,
                 out_format: str = "cf32"):
        if out_format not in ("cf32", "cs16", "cs8"):
            raise ValueError(f"unknown out_format {out_format!r}")
        self.mesh = mesh
        self.batch = batch
        self.f_dev = fields_per_device
        self.n_time = mesh.shape[TIME_AXIS]
        self.n_ch = mesh.shape[CH_AXIS]
        self.t_total = self.n_time * fields_per_device
        self.out_format = out_format
        if batch % self.n_ch:
            raise ValueError(f"batch {batch} does not divide over {self.n_ch} channel shards")

    def init_state(self, field_index: int = 0) -> dict:
        return self.put_state(init_state(self.batch, field_index, device="cpu"))

    def put_state(self, state: EncoderState) -> dict:
        """A full (B, ...) state (host or any device) placed on the mesh."""
        return put_global(state, self.mesh, STATE_SPEC)

    def gather_state(self, state: dict) -> EncoderState:
        """The full state as host numpy leaves (every shard must be local)."""
        return gather(state, self.mesh, STATE_SPEC)

    def gather_iq(self, iq: dict) -> np.ndarray:
        """(T, B, 2, 261120) host IQ from a step's shards."""
        return gather(iq, self.mesh, IQ_SPEC)

    def step(self, state: dict, ts) -> tuple[dict, dict]:
        """ts: (T, B, 58656) uint8 -> (state, {coord: (F, b, 2, 261120)
        planar IQ}): float32 for cf32, int16/int8 codes for cs16/cs8;
        samples [0, 260416) are the field's valid output."""
        if not isinstance(ts, dict):
            ts = put_global(ts, self.mesh, TS_SPEC)
        return _step(self.mesh, state, ts, self.f_dev, self.out_format)


def dryrun(n_devices: int, devices=None) -> None:
    """One full step on an n_devices mesh with both axes in use, in the
    cf32 and the quantized (cs8) output formats."""
    from atsc_tpu_torch.parallel.mesh import make_mesh

    n_time = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_ch = n_devices // n_time
    mesh = make_mesh(n_time, n_ch, devices)
    for fmt, dtype in (("cf32", np.float32), ("cs8", np.int8)):
        enc = ShardedEncoder(mesh, batch=n_ch, fields_per_device=1, out_format=fmt)
        ts = np.zeros((enc.t_total, n_ch, P.FIELD_TS_BYTES), dtype=np.uint8)
        _, iq = enc.step(enc.init_state(), ts)
        out = enc.gather_iq(iq)
        assert out.shape == (enc.t_total, n_ch, 2, P.PADDED_OUT) and out.dtype == dtype
