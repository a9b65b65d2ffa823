"""The 8-VSB transmitter, plain: TS bytes -> randomizer -> RS(207,187) ->
interleaver -> 12 trellis encoders -> field assembly -> pilot offset and
root-raised-cosine FIR -> IQ, in float64, and the cs8 quantizer.

`RefEncoder` carries the per-channel state across fields (the previous RS
field, the trellis carries, the reserved symbols, the field index). A step
computes the symbols only when asked to; otherwise it only advances the
state (`plan`), which is what a check of a few fields out of many needs.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import tables as T
from reference.precision import fir_forward


class RefEncoder:
    """B channels from a cold start at field 0, on `device`."""

    def __init__(self, batch: int, device: torch.device):
        self.batch = batch
        self.device = device
        dev = device
        self.field_index = 0
        self.prev_rs = torch.zeros((batch, T.DATA_PER_FIELD), dtype=torch.uint8, device=dev)
        carry = (batch, T.ENCODERS)
        self.d = torch.zeros(carry, dtype=torch.int32, device=dev)
        self.d1 = torch.zeros(carry, dtype=torch.int32, device=dev)
        self.d2 = torch.zeros(carry, dtype=torch.int32, device=dev)
        self.saved: torch.Tensor | None = torch.zeros((batch, T.RESERVED), dtype=torch.int8,
                                                      device=dev)
        self._rand = torch.tensor(T.randomizer_table(), device=dev)
        self._rs = torch.tensor(T.rs_bit_matrix(), device=dev)
        self._il = torch.tensor(T.interleave_gather(), device=dev)
        self._fsync = torch.tensor(T.field_sync(), device=dev)
        self._shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
        self._weights = (1 << torch.arange(7, -1, -1, dtype=torch.int32, device=dev))

    def _fec(self, ts: torch.Tensor) -> torch.Tensor:
        """(B, 58656) TS -> (B, 12, 5382) interleaved bytes, encoder-major;
        advances prev_rs."""
        b = ts.shape[0]
        payload = ts.reshape(b, T.DATA_SEGMENTS, T.MPEG2_BYTES)[:, :, 1:] ^ self._rand
        bits = ((payload[..., None] >> self._shifts) & 1).reshape(b * T.DATA_SEGMENTS, -1)
        par_bits = (bits.to(torch.float32) @ self._rs).to(torch.int32) & 1
        parity = (par_bits.reshape(b, T.DATA_SEGMENTS, T.RS_BYTES, 8) * self._weights).sum(-1)
        rs = torch.cat([payload, parity.to(torch.uint8)], dim=-1).reshape(b, -1)
        il = torch.index_select(torch.cat([rs, self.prev_rs], dim=-1), 1, self._il)
        self.prev_rs = rs
        return il.reshape(b, T.ENCODERS, T.BYTES_PER_ENCODER)

    def _advance_carries(self, il: torch.Tensor) -> None:
        """The trellis carries after a field from the parities of its bytes."""
        x = il.to(torch.int32)
        s2 = ((x >> 7) ^ (x >> 5) ^ (x >> 3) ^ (x >> 1)) & 1
        su = ((x >> 6) ^ (x >> 2)) & 1
        sv = ((x >> 4) ^ x) & 1
        self.d = (self.d + s2.sum(-1, dtype=torch.int32)) & 1
        self.d1 = (self.d1 + sv.sum(-1, dtype=torch.int32)) & 1
        self.d2 = (self.d2 + su.sum(-1, dtype=torch.int32)) & 1

    def _trellis(self, il: torch.Tensor) -> torch.Tensor:
        """(B, 12, 5382) bytes -> (B, 12, 21528) 3-bit symbols (z2 z1 z0), bit
        pairs MSB first: z2 is X2 through the differential precoder, z1 = X1,
        z0 the state bit of the 2-delay feedback encoder on X1; the carries
        enter as d (precoder), d1, d2."""
        x = il.to(torch.int32)
        x2 = [(x >> k) & 1 for k in (7, 5, 3, 1)]
        x1 = [(x >> k) & 1 for k in (6, 4, 2, 0)]

        def excl(s):  # exclusive XOR prefix over the bytes of each encoder
            return (torch.cumsum(s, dim=-1, dtype=torch.int32) - s) & 1

        s2 = x2[0] ^ x2[1] ^ x2[2] ^ x2[3]
        e2, eu, ev = excl(s2), excl(x1[0] ^ x1[2]), excl(x1[1] ^ x1[3])
        d, d1, d2 = self.d[..., None], self.d1[..., None], self.d2[..., None]
        pre = [x2[0], x2[0] ^ x2[1], x2[0] ^ x2[1] ^ x2[2], s2]
        z0 = [ev ^ d1, eu ^ x1[0] ^ d2, ev ^ x1[1] ^ d1, eu ^ x1[0] ^ x1[2] ^ d2]
        planes = [((e2 ^ pre[p] ^ d) * 4 + x1[p] * 2 + z0[p]).to(torch.int8) for p in range(4)]
        return torch.stack(planes, dim=-1).reshape(il.shape[0], T.ENCODERS, -1)

    def _commutate(self, sym: torch.Tensor) -> torch.Tensor:
        """(B, 12, 21528) encoder-major symbols -> (B, 312, 828) data
        segments: symbol i of segment d from encoder (4d + i) mod 12."""
        b = sym.shape[0]
        per = T.DATA_SYMBOLS_PER_SEGMENT // T.ENCODERS     # 69 a segment an encoder
        t = sym.reshape(b, T.ENCODERS, T.DATA_SEGMENTS, per).permute(0, 2, 3, 1)
        seg = torch.arange(T.DATA_SEGMENTS, device=sym.device)
        enc = (4 * seg[:, None, None] + torch.arange(per * T.ENCODERS, device=sym.device)
               .reshape(1, per, T.ENCODERS)) % T.ENCODERS          # (312, 69, 12)
        return torch.gather(t, 3, enc.expand(b, -1, -1, -1)).reshape(b, T.DATA_SEGMENTS, -1)

    def _assemble(self, data: torch.Tensor) -> torch.Tensor:
        """(B, 312, 828) data segments -> (B, 261248) int8 padded field:
        field sync with the reserved symbols (the previous field's last 12),
        then 312 segments of segment sync and data, then the padding segment
        (a field sync, the FIR's lookahead)."""
        b = data.shape[0]
        parity = self.field_index % 2
        fsync = torch.zeros((b, T.SYMBOLS_PER_SEGMENT), dtype=torch.int8, device=data.device)
        fsync[:, :T.RESERVED_START] = self._fsync[parity]
        fsync[:, T.RESERVED_START:] = self.saved
        segsync = torch.tensor([6, 1, 1, 6], dtype=torch.int8, device=data.device)
        body = torch.cat([segsync.expand(b, T.DATA_SEGMENTS, 4), data], dim=-1)
        pad = torch.zeros_like(fsync)
        pad[:, :T.RESERVED_START] = self._fsync[parity]
        return torch.cat([fsync, body.reshape(b, -1), pad], dim=-1)

    def step(self, ts: torch.Tensor, mode: str = "full") -> torch.Tensor | None:
        """One field: (B, 58656) uint8 TS on the device. mode "full" returns
        the (B, 261248) int8 padded symbol field; "tail" computes only the
        symbols the next field reserves; "skip" only advances the carries
        (the next field then cannot be "full")."""
        il = self._fec(ts)
        field = None
        if mode in ("full", "tail"):
            data = self._commutate(self._trellis(il))
            if mode == "full":
                if self.saved is None:
                    raise ValueError(f"field {self.field_index} is full but the previous "
                                     "field was skipped")
                field = self._assemble(data)
            self.saved = data[:, -1, -T.RESERVED:].clone()
        elif mode == "skip":
            self.saved = None
        else:
            raise ValueError(f"unknown mode {mode!r}")
        self._advance_carries(il)
        self.field_index += 1
        return field


def plan(keys, depth: int) -> dict:
    """Modes that make the fields `keys` and the `depth` fields before each
    full: {field: "full" | "tail"}; every other field is "skip"."""
    modes = {}
    for k in keys:
        for j in range(k - depth, k + 1):
            if j >= 0:
                modes[j] = "full"
        if k - depth - 1 >= 0:
            modes.setdefault(k - depth - 1, "tail")
    return modes


def field_phasor(field_index: int) -> np.ndarray:
    """(2,) float32 oscillator phasor of a field."""
    return T.phasor_sequence(field_index + 1)[field_index]


def modulate(field: torch.Tensor, field_index: int, precision: str = "f64",
             rows: int = 64) -> torch.Tensor:
    """(B, 261248) int8 symbol field -> (B, 2, 260416) float64 IQ: level
    2v - 7 + 1.25, times the oscillator and the field's phasor, through the
    root-raised-cosine FIR; `rows` planes at a time."""
    dev = field.device
    osc = torch.tensor(T.oscillator(), dtype=torch.float64, device=dev)
    pr, pi = (float(v) for v in field_phasor(field_index))
    cr = osc[0] * pr - osc[1] * pi
    ci = osc[0] * pi + osc[1] * pr
    taps = torch.tensor(T.rrc_taps(), dtype=torch.float64, device=dev)
    out = torch.empty((field.shape[0], 2, T.N), dtype=torch.float64, device=dev)
    for lo in range(0, field.shape[0], rows):
        lvl = field[lo:lo + rows].to(torch.float64) * 2 + (T.PILOT - 7)
        lvl[:, T.PADDED - T.RESERVED:] = 0.0
        planes = torch.stack([lvl * cr, lvl * ci], dim=1).reshape(-1, T.PADDED)
        out[lo:lo + rows] = fir_forward(planes, taps, T.N, precision).reshape(-1, 2, T.N)
    return out


def quantize_cs8(iq: torch.Tensor) -> torch.Tensor:
    """float IQ -> int8 codes at cs8_scale, rounded half to even, clipped
    to +-127."""
    q = torch.round(iq * float(T.cs8_scale()))
    return torch.clamp(q, -T.CS8_QMAX, T.CS8_QMAX).to(torch.int8)
