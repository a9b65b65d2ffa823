"""Receive-path field-stream sharding: decode T = n_time * F consecutive
received fields per channel in one step, fields distributed over the
"time" mesh axis, channels over "ch".

Counterpart of atsc_tpu/parallel/rx_shard.py, the mirror of
field_shard.py for the inverse chain. Nothing recurses through decoded
data except the soft tiers' path metrics, so the cross-field state is
light:

  * the trellis precoder state of field k is bit 2 of field k-1's last
    symbol per encoder: one ring-permute of 12 bits a channel;
  * the de-interleaver needs field k-1's interleaved byte image: one
    ring-permute of 64,584 bytes a channel;
  * RS syndromes are field-local.

Every field is trellis-decoded with a zero incoming precoder bit; the
true bit arrives with the ring-permute and affects exactly bit 7 of byte
0, which is patched (`_finish`). The outputs (pre-correction codewords and
syndromes) equal the sequential models/decoder.py chain exactly;
Reed-Solomon correction of dirty segments and de-randomization then run
per shard on its own device (`_correct_and_derand`).

The soft tiers shard too: path metrics recurse through the whole symbol
stream, so each non-first time shard warms flat metrics on the last 128
observations of its left neighbour's stream (one more ring-permute): the
chunked-Viterbi argument, survivors merge within ~32 symbols whp. The
warm-up replays the JAX package's `_acs_scan(m, obs, 16)` /
`_pr_acs_scan` (renormalized every 16 steps) through the plain forward
passes of ops/cuda/viterbi_acs.py (`_acs_plain`, `_pr_plain`): the
kernels renormalize every 24 steps, which would round differently. Each
field's decode is the sequential tiers' viterbi_decode_field /
viterbi_pr_decode_field, so the acs_forward/traceback and
pr_acs_forward/pr_traceback kernels run once per field and shard; the zf
equalizer is one eq_fir_fused launch per field and shard.
"""

from __future__ import annotations

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.models.decoder import (
    DecoderState,
    NtscDecoderState,
    SoftDecoderState,
    init_decoder_state,
    init_ntsc_decoder_state,
    init_soft_decoder_state,
)
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.ops.cuda.viterbi_acs import _acs_plain, _pr_plain, _pr_rc_table
from atsc_tpu_torch.ops.decode import (
    decommutate_field,
    deinterleave_field,
    derandomize_field,
    enc_major_to_round_major,
    trellis_decode_field,
)
from atsc_tpu_torch.ops.ntsc import comb_field, viterbi_pr_decode_field
from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV
from atsc_tpu_torch.ops.rs_decode import rs_correct_field, syndrome_field
from atsc_tpu_torch.ops.viterbi import viterbi_decode_field
from atsc_tpu_torch.parallel.collectives import broadcast_last, ring_permute
from atsc_tpu_torch.parallel.distributed import put_global
from atsc_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh, gather

#: trellis tiers every sharded receive class accepts ('soft-i8' = the
#: int8-quantized soft tier; 'ntsc' = comb + 16-state PR Viterbi)
TRELLIS_TIERS = ("hard", "soft", "soft-i8", "ntsc")
#: observations of the left neighbour's stream a soft shard warms up on
WARMUP = 128

FIELDS_SPEC = (TIME_AXIS, CH_AXIS, None)
CW_SPEC = (TIME_AXIS, CH_AXIS, None, None)
WIN_SPEC = (TIME_AXIS, CH_AXIS, None, None)
OSC_SPEC = (TIME_AXIS, None, None)
_HARD_SPEC = DecoderState(prev_il=(CH_AXIS, None), z2_prev=(CH_AXIS, None))
_SOFT_SPEC = SoftDecoderState(prev_il=(CH_AXIS, None), z2_prev=(CH_AXIS, None),
                              metrics=(CH_AXIS, None, None))
_NTSC_SPEC = NtscDecoderState(prev_il=(CH_AXIS, None), z2_prev=(CH_AXIS, None),
                              metrics=(CH_AXIS, None, None))


def _plumbing(trellis: str, batch: int):
    """(state spec, initial host state) of a trellis tier."""
    if trellis in ("soft", "soft-i8"):
        return _SOFT_SPEC, init_soft_decoder_state(batch, device="cpu")
    if trellis == "ntsc":
        return _NTSC_SPEC, init_ntsc_decoder_state(batch, device="cpu")
    return _HARD_SPEC, init_decoder_state(batch, device="cpu")


def _ring(mesh: Mesh, parts: dict) -> dict:
    return ring_permute(mesh, parts, TIME_AXIS)


def warm_metrics(tail_obs: torch.Tensor) -> torch.Tensor:
    """4-state path metrics warmed from flat zeros over (b, 12, W)
    observations (float32 levels, or int8 soft-level codes, dequantized
    by the same float32 multiply as the ACS): the JAX package's
    `_acs_scan(zeros, obs, 16)`, bit for bit. Returns (b, 12, 4)."""
    b, ne, w = tail_obs.shape
    obs = tail_obs.reshape(b * ne, w).t().contiguous()
    inv = SOFT_LEVEL_INV if obs.dtype == torch.int8 else None
    m0 = torch.zeros((4, b * ne), dtype=torch.float32, device=obs.device)
    _, m = _acs_plain(obs, m0, inv, 16)
    return m.t().reshape(b, ne, 4).contiguous()


def warm_pr_metrics(tail_y: torch.Tensor) -> torch.Tensor:
    """16-state PR path metrics warmed from flat zeros over a field's last
    (b, 12, W) combed observations, with the reset rows of those field
    positions: the JAX package's `_pr_acs_scan(zeros, xs, 16)`. Returns
    (b, 12, 16)."""
    b, ne, w = tail_y.shape
    obs = tail_y.reshape(b * ne, w).t().contiguous()
    dev = obs.device
    rc = const(_pr_rc_table, dev)[-w:]          # the field's last w positions
    enc = torch.arange(b * ne, device=dev) % P.TRELLIS_ENCODERS
    m0 = torch.zeros((16, b * ne), dtype=torch.float32, device=dev)
    _, m = _pr_plain(obs, lambda t0, t1: rc[t0:t1][:, enc], m0, 16)
    return m.t().reshape(b, ne, 16).contiguous()


def _decode_hard(fields: dict):
    """Per-field trellis inverse of sliced symbols: {coord: (bytes (F, b,
    12, 5382) decoded with a zero incoming precoder bit, z2 tails (F, b,
    12))}, and no metrics."""
    out = {}
    for c, x in fields.items():
        f, b = x.shape[:2]
        syms = decommutate_field(x.reshape(f * b, -1))
        zeros = torch.zeros((f * b, P.TRELLIS_ENCODERS), dtype=torch.int32, device=x.device)
        by, z2t = trellis_decode_field(syms, zeros)
        out[c] = (by.reshape(f, b, *by.shape[1:]), z2t.reshape(f, b, -1), None)
    return out


def _decode_ml(mesh: Mesh, state: dict, fields: dict, ntsc: bool):
    """Soft (4-state) or NTSC (comb + 16-state PR) maximum-likelihood
    decode of each shard's F fields in order, the metrics warmed at the
    shard seam; returns {coord: (bytes, z2 tails, final metrics)}."""
    obs = {}
    for c, x in fields.items():
        f, b = x.shape[:2]
        flat = x.reshape(f * b, -1)
        if ntsc:
            flat = comb_field(flat.to(torch.float32))
        elif flat.dtype != torch.int8:
            flat = flat.to(torch.float32)
        obs[c] = decommutate_field(flat).reshape(f, b, P.TRELLIS_ENCODERS, -1)
    tail = _ring(mesh, {c: o[-1][..., -WARMUP:] for c, o in obs.items()})
    warm = warm_pr_metrics if ntsc else warm_metrics
    decode = viterbi_pr_decode_field if ntsc else viterbi_decode_field
    out = {}
    for c, o in obs.items():
        metrics = state[c].metrics if c[0] == 0 else warm(tail[c])
        zeros = torch.zeros(o.shape[1:3], dtype=torch.int32, device=o.device)
        bys, z2s = [], []
        for f in range(o.shape[0]):
            by, z2t, metrics = decode(o[f], zeros, metrics)
            bys.append(by)
            z2s.append(z2t)
        out[c] = (torch.stack(bys), torch.stack(z2s), metrics)
    return out


def _finish(mesh: Mesh, state: dict, decoded: dict, state_cls):
    """Shared tail of every tier: ring-permute the precoder tails and fix
    bit 7 of byte 0 (x2 of pair 0 is z2_0 ^ z2_prev; the zero-z2_prev
    decode emitted z2_0), de-interleave against the left neighbour's
    field, syndromes, and the next state (the last time shard's,
    replicated). Returns (new state, codewords, syndromes)."""
    z2_left = _ring(mesh, {c: d[1][-1] for c, d in decoded.items()})
    cur_il = {}
    for c, (by, z2t, _) in decoded.items():
        incoming = state[c].z2_prev if c[0] == 0 else z2_left[c]
        z2_prev = torch.cat([incoming[None], z2t[:-1]])
        fixed = by.clone()
        fixed[..., 0] ^= ((z2_prev & 1) << 7).to(torch.uint8)
        f, b = by.shape[:2]
        cur_il[c] = enc_major_to_round_major(fixed.reshape(f * b, *by.shape[2:])).reshape(f, b, -1)
    il_left = _ring(mesh, {c: il[-1] for c, il in cur_il.items()})
    cw, syn = {}, {}
    for c, il in cur_il.items():
        incoming = state[c].prev_il if c[0] == 0 else il_left[c]
        prev = torch.cat([incoming[None], il[:-1]])
        f, b = il.shape[:2]
        rs = deinterleave_field(il.reshape(f * b, -1), prev.reshape(f * b, -1))
        words = rs.reshape(f * b, P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES)
        cw[c] = words.reshape(f, b, P.DATA_SEGMENTS, -1)
        syn[c] = syndrome_field(words).reshape(f, b, P.DATA_SEGMENTS, -1)
    leaves = {"prev_il": broadcast_last(mesh, {c: il[-1] for c, il in cur_il.items()}, TIME_AXIS),
              "z2_prev": broadcast_last(mesh, {c: d[1][-1] for c, d in decoded.items()},
                                        TIME_AXIS)}
    if "metrics" in state_cls._fields:
        leaves["metrics"] = broadcast_last(mesh, {c: d[2] for c, d in decoded.items()},
                                           TIME_AXIS)
    new_state = {c: state_cls(**{k: v[c] for k, v in leaves.items()}) for c in cur_il}
    return new_state, cw, syn


def decode_step(mesh: Mesh, trellis: str, state: dict, fields: dict):
    """The sharded decode body for a trellis tier: {coord: (F, b,
    >=260416) fields} (int8 symbols for 'hard', float32 levels for 'soft'
    and 'ntsc', int8 soft-level codes for 'soft-i8') -> (new state,
    codewords {coord: (F, b, 312, 207)}, syndromes {coord: (F, b, 312,
    20)})."""
    if trellis == "hard":
        decoded = _decode_hard(fields)
    else:
        decoded = _decode_ml(mesh, state, fields, ntsc=trellis == "ntsc")
    return _finish(mesh, state, decoded, type(next(iter(state.values()))))


def _correct_and_derand(obj, mesh: Mesh, cw: dict, syn: dict):
    """Per shard, on its device: RS-correct the dirty segments (counting
    into obj.segments_corrected / segments_uncorrectable) and
    de-randomize. Returns ({coord: ts (F, b, 58656) uint8}, {coord:
    n_errors (F, b, 312) int32; -1 marks uncorrectable segments})."""
    ts, nerr = {}, {}
    for c, words in cw.items():
        f, b = words.shape[:2]
        flat = words.reshape(f * b, P.DATA_SEGMENTS, -1)
        n = torch.zeros((f * b, P.DATA_SEGMENTS), dtype=torch.int32, device=words.device)
        if bool((syn[c] != 0).any()):
            flat, n = rs_correct_field(flat, syn[c].reshape(f * b, P.DATA_SEGMENTS, -1))
            obj.segments_corrected += int((n > 0).sum())
            obj.segments_uncorrectable += int((n < 0).sum())
        ts[c] = derandomize_field(flat).reshape(f, b, -1)
        nerr[c] = n.reshape(f, b, -1)
    return ts, nerr


class _ShardedBase:
    """What the sharded decoder and receiver share: the mesh, the state
    (placed; `state` gathers it), RS counters and the output gather."""

    def _setup(self, mesh: Mesh, batch: int, fields_per_device: int, trellis: str):
        if trellis not in TRELLIS_TIERS:
            raise ValueError(f"unknown trellis mode {trellis!r}")
        self.mesh = mesh
        self.batch = batch
        self.f_dev = fields_per_device
        self.trellis = trellis
        self.n_time = mesh.shape[TIME_AXIS]
        self.n_ch = mesh.shape[CH_AXIS]
        self.t_total = self.n_time * fields_per_device
        if batch % self.n_ch:
            raise ValueError(f"batch {batch} does not divide over {self.n_ch} channel shards")
        self.segments_corrected = 0
        self.segments_uncorrectable = 0
        self.state_spec, init = _plumbing(trellis, batch)
        self._state = put_global(init, mesh, self.state_spec)

    @property
    def state(self):
        """The carried state, gathered to host numpy leaves."""
        return gather(self._state, self.mesh, self.state_spec)

    def set_state(self, state) -> None:
        """Place a full (B, ...) state (host numpy or tensors) on the mesh."""
        self._state = put_global(state, self.mesh, self.state_spec)

    def _outputs(self, cw: dict, syn: dict) -> tuple[np.ndarray, np.ndarray]:
        ts, nerr = _correct_and_derand(self, self.mesh, cw, syn)
        return gather(ts, self.mesh, FIELDS_SPEC), gather(nerr, self.mesh, FIELDS_SPEC)


class ShardedDecoder(_ShardedBase):
    """Multi-device symbol-field decoder over a ("time", "ch") mesh.

    Decodes T = n_time * fields_per_device consecutive received fields for
    B channels per step; B must be divisible by n_ch. Step k's output TS
    fields are shifted by one exactly like the sequential Decoder (a
    cold-start decoder's first output field is the encoder's virtual
    pre-start field: drop it).
    """

    def __init__(self, mesh: Mesh, batch: int, fields_per_device: int = 1,
                 trellis: str = "hard"):
        self._setup(mesh, batch, fields_per_device, trellis)

    def step(self, fields) -> tuple[dict, dict]:
        """One sharded step from full fields or placed shards: (codewords,
        syndromes) per shard, before correction; advances the state."""
        if not isinstance(fields, dict):
            fields = put_global(fields, self.mesh, FIELDS_SPEC)
        self._state, cw, syn = decode_step(self.mesh, self.trellis, self._state, fields)
        return cw, syn

    def decode(self, fields) -> tuple[np.ndarray, np.ndarray]:
        """(T, B, >=260416) received fields k..k+T-1 (int8 sliced symbols
        for 'hard'; float32 soft levels for 'soft' and 'ntsc'; int8
        soft-level codes for 'soft-i8') -> (ts (T, B, 58656) uint8 of
        fields k-1..k+T-2, n_errors (T, B, 312) int32)."""
        return self._outputs(*self.step(fields))


class ShardedReceiver(_ShardedBase):
    """Full multi-device receive chain: planar IQ in, TS out.

    Each shard equalizes its own fields (the window context comes from the
    host in overlapping windows; the equalizer needs no exchange) and then
    runs the sharded decode body above.

    equalizer: "zf" (the eq_fir_fused kernel per field, with the window
    geometry of models/receiver.py eq_window_bounds), or "adaptive" /
    "adaptive-dd" (per-field sync-trained WL-RLS, ops/adaptive_eq.py).
    Adaptive training is strictly per field (the sequential IqReceiver's
    forgetting=0.0), which makes the equalizer shard with no cross-shard
    state: the output equals the sequential forgetting=0 receiver's.
    train_every=k (adaptive only, k | fields_per_device): each time shard
    trains on its local multiples of k and applies the cached taps
    between, the sequential cadence schedule exactly.

    trellis: "hard", "soft", "soft-i8" or "ntsc"; the ML tiers shard with
    the zf equalizer. wire_format cs16/cs8: decode_codes uploads the
    integer codes verbatim and the kernel dequantizes them.
    """

    def __init__(self, mesh: Mesh, batch: int, fields_per_device: int = 1,
                 first_field: int = 0, eq_profile: str = "auto",
                 equalizer: str = "zf", trellis: str = "hard",
                 wire_format: str = "cf32", train_every: int = 1):
        from atsc_tpu_torch.models.receiver import _DEV_MARGIN, EQ_PROFILES, eq_window_bounds
        from atsc_tpu_torch.ops.quantize import quantize_scale

        if equalizer not in ("zf", "adaptive", "adaptive-dd"):
            raise ValueError(f"unknown equalizer {equalizer!r}")
        if trellis not in TRELLIS_TIERS:
            raise ValueError(f"unknown trellis mode {trellis!r}")
        if wire_format not in ("cf32", "cs16", "cs8"):
            raise ValueError(f"unknown wire format {wire_format!r}")
        if eq_profile != "auto" and eq_profile not in EQ_PROFILES:
            raise ValueError(f"unknown eq profile {eq_profile!r}")
        if equalizer != "zf" and (trellis != "hard" or wire_format != "cf32"):
            raise ValueError("ML trellis tiers / quantized windows shard "
                             "with the zf equalizer (the adaptive tiers "
                             "stay hard-symbol, cf32 — use the "
                             "sequential IqReceiver for those combos)")
        if train_every != 1 and equalizer == "zf":
            raise ValueError("train_every is the adaptive equalizer's "
                             "retrain cadence — zf does not train")
        if train_every < 1 or fields_per_device % train_every:
            raise ValueError(
                f"train_every={train_every} must divide "
                f"fields_per_device={fields_per_device}: the cadence "
                "is device-local (each time shard trains on its own "
                "multiples-of-k local fields, which equals the "
                "sequential schedule exactly when k | F)")
        self._setup(mesh, batch, fields_per_device, trellis)
        self.wire_format = wire_format
        self.equalizer = equalizer
        self.eq_profile = eq_profile
        self.train_every = train_every
        self._dequant = 1.0 if wire_format == "cf32" else 1.0 / quantize_scale(wire_format)
        #: public edge context of decode_iq/decode_codes(with_context=True)
        self._margin = _DEV_MARGIN
        if equalizer == "zf":
            lo_off, self.window = eq_window_bounds(eq_profile)
            self._eq_margin = -lo_off
        else:
            self.window = P.SYMBOLS_PER_FIELD + 2 * _DEV_MARGIN
            self._eq_margin = _DEV_MARGIN
        self._next_field = first_field       # oscillator epoch counter
        self._adaptive: dict = {}            # coord -> AdaptiveEqualizer

    @property
    def eq_margin(self) -> int:
        """Samples of left context the equalizer window takes before a
        field's first sample (the window covers [g0 - eq_margin,
        g0 - eq_margin + window))."""
        return self._eq_margin

    def _equalizer(self, coord):
        """The adaptive equalizer of a shard (created on first use)."""
        from atsc_tpu_torch.models.receiver import _ADAPTIVE_PRECISION, DEFAULT_EQ_PROFILE
        from atsc_tpu_torch.ops.adaptive_eq import AdaptiveEqualizer

        if coord not in self._adaptive:
            key = DEFAULT_EQ_PROFILE if self.eq_profile == "auto" else self.eq_profile
            self._adaptive[coord] = AdaptiveEqualizer(
                batch=self.batch // self.n_ch, forgetting=0.0, ridge=1e-4,
                apply_precision=_ADAPTIVE_PRECISION[key],
                decision_directed=self.equalizer == "adaptive-dd",
                train_every=self.train_every, device=self.mesh.device(coord))
        return self._adaptive[coord]

    def _equalize(self, wins: dict, oscs: dict, start_parity: int) -> dict:
        """{coord: (F, b, 2, window)} windows and {coord: (F, 2, window)}
        oscillator spans -> {coord: (F, b, 260416)} fields for the tier:
        int8 symbols (hard), float32 levels (soft, ntsc) or int8
        soft-level codes (soft-i8)."""
        from atsc_tpu_torch.models.receiver import device_eq_step

        soft = self.trellis in ("soft", "soft-i8", "ntsc")
        out = {}
        for c, win in wins.items():
            if self.equalizer == "zf":
                step = device_eq_step(soft, self._dequant, self.eq_profile,
                                      soft_q=self.trellis == "soft-i8")
                out[c] = torch.stack([step(win[f], oscs[c][f]) for f in range(win.shape[0])])
                continue
            eq = self._equalizer(c)
            g0 = start_parity + c[self.mesh.axis(TIME_AXIS)] * self.f_dev
            out[c] = torch.stack([eq.process_field(win[f], oscs[c][f], (g0 + f) % 2)
                                  for f in range(win.shape[0])])
        return out

    def step(self, wins, oscs, start_parity: int) -> tuple[dict, dict]:
        """One sharded step from windows (T, B, 2, window) and oscillator
        spans (T, 2, window), full arrays or placed shards (a
        multi-process driver places its own, put_global with WIN_SPEC and
        OSC_SPEC); start_parity is the step's first field's parity.
        Returns (codewords, syndromes) per shard; advances the state."""
        if not isinstance(wins, dict):
            wins = put_global(wins, self.mesh, WIN_SPEC)
        if not isinstance(oscs, dict):
            oscs = put_global(oscs, self.mesh, OSC_SPEC)
        fields = self._equalize(wins, oscs, start_parity)
        self._state, cw, syn = decode_step(self.mesh, self.trellis, self._state, fields)
        return cw, syn

    def _advance(self) -> int:
        start = self._next_field
        self._next_field += self.t_total
        return start

    def windows_iq(self, iq: np.ndarray, with_context: bool = False):
        """The step's (T, B, 2, window) float32 windows and (T, 2, window)
        oscillator spans from iq (B, T*260416) complex, field-aligned
        (with_context: 384 more samples of real context on each side);
        missing context is zero-filled."""
        from atsc_tpu_torch.models.receiver import field_window

        iq = np.atleast_2d(iq)
        n = P.SYMBOLS_PER_FIELD
        off = -self._margin if with_context else 0
        if iq.shape[1] != self.t_total * n - 2 * off:
            raise ValueError(f"want exactly {self.t_total} fields of samples"
                             + (" + 2*384 context" if with_context else ""))
        wins = np.empty((self.t_total, iq.shape[0], 2, self.window), np.float32)
        oscs = np.empty((self.t_total, 2, self.window), np.float32)
        for f in range(self.t_total):
            # the oscillator epoch is this step's first stream field
            wins[f], oscs[f] = field_window(
                iq, f * n, first_field=self._next_field, stream_offset=off,
                margin=self._eq_margin, length=self.window)
        return wins, oscs

    def decode_iq(self, iq: np.ndarray, with_context: bool = False
                  ) -> tuple[np.ndarray, np.ndarray]:
        """iq: (B, T*260416) complex baseband, the next T = t_total
        consecutive fields of the stream, field-aligned; with_context=True:
        (B, T*260416 + 768), 384 samples of real context on each side, so
        the equalizer sees the stream across step edges (otherwise the
        edges are zero-filled and RS absorbs the boundary symbols).
        Returns (ts (T, B, 58656), n_errors (T, B, 312)) with the usual
        one-field output latency."""
        if self.wire_format != "cf32":
            raise ValueError("this receiver consumes integer wire codes "
                             "— use decode_codes()")
        wins, oscs = self.windows_iq(iq, with_context)
        return self._outputs(*self.step(wins, oscs, self._advance() % 2))

    def decode_codes(self, codes: np.ndarray, with_context: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Quantized twin of decode_iq for wire_format 'cs16'/'cs8': codes
        (B, T*260416, 2) int16/int8 interleaved (I, Q) wire samples (with
        context: T*260416 + 768), uploaded verbatim; the equalizer kernel
        dequantizes them."""
        from atsc_tpu_torch.models.receiver import _osc_planar

        if self.wire_format == "cf32":
            raise ValueError("decode_codes needs wire_format='cs16'/'cs8'")
        codes = np.asarray(codes)
        if codes.ndim == 2:
            codes = codes[None]
        n = P.SYMBOLS_PER_FIELD
        off = -self._margin if with_context else 0
        if codes.shape[1] != self.t_total * n - 2 * off:
            raise ValueError(f"want exactly {self.t_total} fields of code samples"
                             + (" + 2*384 context" if with_context else ""))
        b = codes.shape[0]
        wins = np.zeros((self.t_total, b, 2, self.window), codes.dtype)
        oscs = np.empty((self.t_total, 2, self.window), np.float32)
        for f in range(self.t_total):
            lo = f * n - self._eq_margin
            hi = lo + self.window
            a_lo, a_hi = max(lo, off), min(hi, codes.shape[1] + off)
            if a_hi > a_lo:
                src = codes[:, a_lo - off : a_hi - off]
                wins[f, :, 0, a_lo - lo : a_hi - lo] = src[..., 0]
                wins[f, :, 1, a_lo - lo : a_hi - lo] = src[..., 1]
            oscs[f] = _osc_planar(lo, hi, self._next_field)
        return self._outputs(*self.step(wins, oscs, self._advance() % 2))


def dryrun(n_devices: int, devices=None) -> None:
    """One step on an n_devices mesh with both axes in use, through the
    symbol-field decoder (hard, soft, soft-i8, ntsc) and the IQ receive
    chain (zf, adaptive, the ML tiers, cs8 windows), on zero input."""
    from atsc_tpu_torch.parallel.mesh import make_mesh

    n_time = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_ch = n_devices // n_time
    mesh = make_mesh(n_time, n_ch, devices)
    shape = (n_time, n_ch, P.SYMBOLS_PER_FIELD)
    want = (n_time, n_ch, P.FIELD_TS_BYTES)
    for tier, dtype in (("hard", np.int8), ("soft", np.float32), ("soft-i8", np.int8),
                        ("ntsc", np.float32)):
        ts, _ = ShardedDecoder(mesh, n_ch, trellis=tier).decode(np.zeros(shape, dtype))
        assert ts.shape == want
    iq = np.zeros((n_ch, n_time * P.SYMBOLS_PER_FIELD), np.complex64)
    for kw in (dict(), dict(equalizer="adaptive"), dict(trellis="soft"),
               dict(trellis="soft-i8"), dict(trellis="ntsc")):
        ts, _ = ShardedReceiver(mesh, n_ch, **kw).decode_iq(iq)
        assert ts.shape == want
    codes = np.zeros((n_ch, n_time * P.SYMBOLS_PER_FIELD, 2), np.int8)
    ts, _ = ShardedReceiver(mesh, n_ch, wire_format="cs8").decode_codes(codes)
    assert ts.shape == want
