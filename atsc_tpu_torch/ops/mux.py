"""FDM multiplexer: B encoded 8VSB channels -> one wideband multiplex, and
its inverse.

Counterpart of atsc_tpu/ops/mux.py. A broadcast headend drives one wideband
DAC with many 6-MHz channels at once. The ATSC numerology makes the rate
change exact: fs = 4.5 MHz * 684/286, so fs * 286/513 = 6 MHz, and a
multiplex of B slots at R = B * 6 MHz is the rational ratio 286*B/513. Every
513 input samples give exactly 286*B output samples, with no fractional
phase to carry.

* Resampling is one banded matmul per 513-sample input block:
  out_block = window(513 + 2H) @ W, W[i, m] = kaiser_sinc(m*q/p + H - i),
  one W shared by all slots. The windows are a strided view of the input
  (`unfold`), never a gathered copy.
* The slot mixer e^{j*2*pi*(2k-B+1)/(2B)*m} has period 2B samples and every
  block's 286*B outputs are a multiple of 2B, so mixing multiplies by one
  small table, phase-continuous across blocks with no carried phasor.
* The demultiplexer mixes each slot down to DC, low-passes at 3.1 MHz and
  resamples R -> fs in one banded matmul per 286*B-sample block.

The tables are built in float64 numpy exactly as the JAX package builds
them and cast to float32, so both packages use the same numbers. The block
products run on the muxer's device as torch.matmul in true float32 whatever
the caller has set (TF32 off; the JAX package computes them at
Precision.HIGHEST, outside any Pallas kernel). The streaming carries
(`FdmMuxer`, `FdmDemuxer`) live on their device; `get_state`/`set_state`
hand numpy arrays across in the JAX package's layout. `demux_slot` is the
host numpy verification inverse of one slot.

Slots sit symmetrically around DC: slot k of B at (k - (B-1)/2) * 6 MHz.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.ops.adaptive_eq import fp32_matmul

RESAMPLE_UP = 286           # output samples per slot per input block...
RESAMPLE_DOWN = 513         # ...of this many input samples (exact 6 MHz)
SLOT_HZ = 6_000_000.0
_HALO = 16                  # one-sided resampler support (input samples)


@functools.lru_cache(maxsize=8)
def _resample_matrix(n_slots: int) -> np.ndarray:
    """(513 + 2*HALO, 286*n_slots) float32 banded interpolation matrix
    for the rational fs -> n_slots*6 MHz resampler (Kaiser(10)-windowed
    sinc at the input rate; pure interpolation, p/q > 1)."""
    p = RESAMPLE_UP * n_slots
    q = RESAMPLE_DOWN
    m = np.arange(p, dtype=np.float64)
    pos = m * q / p + _HALO            # input position of output m
    i = np.arange(q + 2 * _HALO, dtype=np.float64)[:, None]
    t = pos[None, :] - i               # offset in input samples
    x = np.clip(t / (_HALO + 1), -1.0, 1.0)
    w = np.sinc(t) * np.i0(10.0 * np.sqrt(1.0 - x * x)) / np.i0(10.0)
    w[np.abs(t) > _HALO + 1] = 0.0
    # unity DC gain per output phase
    w /= w.sum(axis=0, keepdims=True)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mixer_tables(n_slots: int) -> tuple[np.ndarray, np.ndarray]:
    """((B, 2B) cos, (B, 2B) sin) slot-mixer tables: slot k's carrier
    e^{j*2*pi*(2k-B+1)/(2B)*m} sampled over its 2B-sample period."""
    b = n_slots
    k = np.arange(b)[:, None]
    m = np.arange(2 * b)[None, :]
    ph = 2 * np.pi * (2 * k - b + 1) / (2 * b) * m
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _demux_matrix(n_slots: int) -> np.ndarray:
    """(286*B + 2*H2, 513) float32 banded filter-and-resample matrix for
    the multiplex -> per-slot baseband direction: anti-alias low-pass
    (Kaiser(10) sinc, 3.1 MHz cutoff, which removes the 6-MHz neighbours)
    and R -> fs interpolation in one matmul per 286*B-sample input block."""
    p_in = RESAMPLE_UP * n_slots       # input samples per block (at R)
    q_out = RESAMPLE_DOWN              # output samples per block (at fs)
    rate = n_slots * SLOT_HZ
    halo = _demux_halo(n_slots)
    m = np.arange(q_out, dtype=np.float64)
    pos = m * p_in / q_out + halo      # input position of output m
    i = np.arange(p_in + 2 * halo, dtype=np.float64)[:, None]
    t = pos[None, :] - i
    c = 2 * 3.1e6 / rate               # normalized low-pass cutoff
    x = np.clip(t / (halo + 1), -1.0, 1.0)
    w = c * np.sinc(c * t) * np.i0(10.0 * np.sqrt(1.0 - x * x)) / np.i0(10.0)
    w[np.abs(t) > halo + 1] = 0.0
    w /= w.sum(axis=0, keepdims=True)  # unity DC gain per phase
    return w.astype(np.float32)


def _demux_halo(n_slots: int) -> int:
    """One-sided demux filter support in multiplex samples: the 3.1-MHz
    low-pass needs length scaling with the rate for a fixed transition."""
    return 12 * n_slots + 4


@functools.lru_cache(maxsize=16)
def _tables(n_slots: int, device: torch.device) -> dict:
    """The float32 tables of n_slots on `device`, made once."""
    cos_t, sin_t = _mixer_tables(n_slots)

    def on(a):
        return torch.tensor(np.ascontiguousarray(a), device=device)

    return {"mux": on(_resample_matrix(n_slots)), "demux": on(_demux_matrix(n_slots)),
            "cos": on(cos_t), "sin": on(sin_t)}


def mux_blocks(iq_planar: torch.Tensor) -> torch.Tensor:
    """(B, 2, n_in + 2*HALO) planar float32 channel IQ (n_in a multiple of
    513, with HALO context samples on each side) -> (2, n_in*286*B/513)
    planar multiplex at B*6 MHz, on the input's device.

    The input must be block-aligned to the stream: sample HALO of the last
    axis is stream sample `blocks_consumed * 513` of every channel
    (FdmMuxer handles the carry); output sample 0 is then multiplex sample
    `blocks_consumed * 286*B`, keeping the 2B-periodic mixer aligned.
    """
    b, _, n_win = iq_planar.shape
    q, halo = RESAMPLE_DOWN, _HALO
    n_blk = (n_win - 2 * halo) // q
    tab = _tables(b, iq_planar.device)
    win = iq_planar.unfold(-1, q + 2 * halo, q)[:, :, :n_blk]   # (B, 2, n_blk, q+2H) view
    with fp32_matmul():
        res = torch.matmul(win, tab["mux"])                    # (B, 2, n_blk, 286*B)
    reps = n_blk * RESAMPLE_UP // 2                             # 2B-sample mixer periods
    res = res.reshape(b, 2, reps, 2 * b)
    cos, sin = tab["cos"][:, None, :], tab["sin"][:, None, :]   # (B, 1, 2B)
    out_re = (res[:, 0] * cos - res[:, 1] * sin).sum(dim=0)
    out_im = (res[:, 0] * sin + res[:, 1] * cos).sum(dim=0)
    return torch.stack([out_re, out_im]).reshape(2, reps * 2 * b)


def demux_blocks(mux_planar: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(2, n_in + 2*halo) planar float32 multiplex (n_in a multiple of
    286*B, with halo context on each side) -> (B, 2, n_in*513/(286*B))
    planar per-slot baseband at fs, on the input's device.

    Same alignment contract as mux_blocks: input sample `halo` is multiplex
    stream sample blocks_consumed*286*B, so the period-2B mixdown table
    stays phase-aligned with no carried state.
    """
    b = n_slots
    p_in = RESAMPLE_UP * b
    halo = _demux_halo(b)
    n_win = mux_planar.shape[-1]
    n_blk = (n_win - 2 * halo) // p_in
    tab = _tables(b, mux_planar.device)
    # mix every slot down to DC: the conjugate of the mux mixer, its table
    # started at -halo (mod 2B)
    idx = (torch.arange(n_win, device=mux_planar.device) + (-halo) % (2 * b)) % (2 * b)
    cos, sin = tab["cos"][:, idx], tab["sin"][:, idx]          # (B, n_win)
    xr, xi = mux_planar[0], mux_planar[1]
    dr = xr[None] * cos + xi[None] * sin                       # x * conj(mix)
    di = xi[None] * cos - xr[None] * sin
    del cos, sin
    size = p_in + 2 * halo
    with fp32_matmul():
        out_r = torch.matmul(dr.unfold(-1, size, p_in)[:, :n_blk], tab["demux"])
        out_i = torch.matmul(di.unfold(-1, size, p_in)[:, :n_blk], tab["demux"])
    return torch.stack([out_r, out_i], dim=1).reshape(b, 2, n_blk * RESAMPLE_DOWN)


class FdmMuxer:
    """Streaming multiplexer: push per-channel planar IQ, collect the
    wideband multiplex.

    n_slots: channel count B; slot k sits at (k - (B-1)/2) * 6 MHz.
    push() takes (B, 2, n) float32 planar IQ chunks (a tensor on any device,
    e.g. the encoder's per-field output, valid samples only, or numpy) and
    returns the newly available (2, m) float32 numpy multiplex samples at
    B*6 MHz; a 513-sample input-block remainder plus the resampler halo
    carry across pushes on `device` (flush() zero-fills the tail).
    """

    def __init__(self, n_slots: int, *, device: str | torch.device = "cuda"):
        self.n_slots = n_slots
        self.rate_hz = n_slots * SLOT_HZ
        self.device = resolve_device(device)
        self._carry = torch.zeros((n_slots, 2, _HALO), dtype=torch.float32,
                                  device=self.device)

    def _run(self, buf: torch.Tensor) -> np.ndarray:
        """buf: (B, 2, 2*HALO + k*513 + r). Consumes the k whole blocks,
        keeps the remainder (+ halo) as the next carry."""
        q, halo = RESAMPLE_DOWN, _HALO
        n_blk = (buf.shape[-1] - 2 * halo) // q
        if n_blk <= 0:
            self._carry = buf
            return np.zeros((2, 0), np.float32)
        used = n_blk * q
        out = mux_blocks(buf[..., : used + 2 * halo]).cpu().numpy()
        self._carry = buf[..., used:].clone()
        return out

    def push(self, iq_planar) -> np.ndarray:
        if isinstance(iq_planar, torch.Tensor):
            x = iq_planar.to(device=self.device, dtype=torch.float32)
        else:
            x = torch.from_numpy(np.ascontiguousarray(iq_planar, np.float32)).to(self.device)
        if x.shape[0] != self.n_slots or x.ndim != 3:
            raise ValueError(
                f"want ({self.n_slots}, 2, n) planar IQ, got {tuple(x.shape)}")
        return self._run(torch.cat([self._carry, x], dim=-1))

    def get_state(self) -> np.ndarray:
        """The complete resumable state: the carried halo + remainder
        samples, (B, 2, n) float32 (the mixer and resampler are
        block-aligned and stateless)."""
        return self._carry.cpu().numpy().copy()

    def set_state(self, carry: np.ndarray) -> None:
        carry = np.asarray(carry, np.float32)
        if carry.ndim != 3 or carry.shape[:2] != (self.n_slots, 2):
            raise ValueError(f"want ({self.n_slots}, 2, n) carry, got {carry.shape}")
        self._carry = torch.from_numpy(carry.copy()).to(self.device)

    def flush(self) -> np.ndarray:
        """End of stream: zero-fill the trailing partial block (plus the
        final halo) and emit everything still buffered."""
        q, halo = RESAMPLE_DOWN, _HALO
        # carry layout: [halo context | s un-consumed stream samples]
        s = self._carry.shape[-1] - halo
        zeros = functools.partial(torch.zeros, dtype=torch.float32, device=self.device)
        if s <= 0:
            self._carry = zeros((self.n_slots, 2, halo))
            return np.zeros((2, 0), np.float32)
        pad = (-s) % q + halo
        out = self._run(torch.cat([self._carry, zeros((self.n_slots, 2, pad))], dim=-1))
        self._carry = zeros((self.n_slots, 2, halo))
        return out


class FdmDemuxer:
    """Streaming inverse of FdmMuxer: push wideband multiplex samples at
    B*6 MHz, collect per-slot complex basebands at the symbol rate, ready
    for IqReceiver(batch=B, backend="adaptive") (the demux filter is a
    linear channel the training absorbs). The carried halo and remainder
    live on `device`.
    """

    def __init__(self, n_slots: int, *, device: str | torch.device = "cuda"):
        self.n_slots = n_slots
        self.rate_hz = n_slots * SLOT_HZ  # the multiplex sample rate
        self.device = resolve_device(device)
        self._carry = torch.zeros((2, _demux_halo(n_slots)), dtype=torch.float32,
                                  device=self.device)

    def push(self, mux_planar) -> np.ndarray:
        """mux_planar: (2, n) planar float32 (or (n,) complex) multiplex
        samples, numpy or a tensor. Returns (B, m) complex64 numpy baseband
        (possibly m = 0)."""
        if isinstance(mux_planar, torch.Tensor):
            x = mux_planar.to(device=self.device, dtype=torch.float32)
        else:
            mux_planar = np.asarray(mux_planar)
            if mux_planar.ndim == 1:
                mux_planar = np.stack([mux_planar.real.astype(np.float32),
                                       mux_planar.imag.astype(np.float32)])
            x = torch.from_numpy(np.ascontiguousarray(mux_planar, np.float32)).to(self.device)
        buf = torch.cat([self._carry, x], dim=-1)
        p_in = RESAMPLE_UP * self.n_slots
        halo = _demux_halo(self.n_slots)
        n_blk = (buf.shape[-1] - 2 * halo) // p_in
        if n_blk <= 0:
            self._carry = buf
            return np.zeros((self.n_slots, 0), np.complex64)
        used = n_blk * p_in
        out = demux_blocks(buf[..., : used + 2 * halo], self.n_slots).cpu().numpy()
        self._carry = buf[..., used:].clone()
        return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)

    def get_state(self) -> np.ndarray:
        """The complete resumable state: the carried halo + remainder
        samples, (2, n) float32 (mixdown and resampler are block-aligned
        and stateless)."""
        return self._carry.cpu().numpy().copy()

    def set_state(self, carry: np.ndarray) -> None:
        carry = np.asarray(carry, np.float32)
        if carry.ndim != 2 or carry.shape[0] != 2:
            raise ValueError(f"want (2, n) carry, got {carry.shape}")
        self._carry = torch.from_numpy(carry.copy()).to(self.device)

    def flush(self) -> np.ndarray:
        """End of stream: zero-fill the trailing partial block + halo."""
        p_in = RESAMPLE_UP * self.n_slots
        halo = _demux_halo(self.n_slots)
        s = self._carry.shape[-1] - halo
        if s <= 0:
            self._carry = torch.zeros((2, halo), dtype=torch.float32, device=self.device)
            return np.zeros((self.n_slots, 0), np.complex64)
        pad = (-s) % p_in + halo
        out = self.push(np.zeros((2, pad), np.float32))
        self._carry = torch.zeros((2, halo), dtype=torch.float32, device=self.device)
        return out


def demux_slot(mux: np.ndarray, slot: int, n_slots: int) -> np.ndarray:
    """Extract one channel from a multiplex back to complex baseband at the
    symbol rate (host numpy, float64; the verification and monitoring
    inverse of FdmMuxer, whose linear distortion the receiver's adaptive
    equalizer absorbs).

    mux: (2, M) planar or (M,) complex multiplex at n_slots*6 MHz.
    Returns (m,) complex64 at fs = 10.762238 MHz.
    """
    from atsc_tpu_torch.models.receiver import resample_stream

    if mux.ndim == 2:
        x = mux[0].astype(np.complex128) + 1j * mux[1]
    else:
        x = np.asarray(mux, np.complex128)
    b = n_slots
    m = np.arange(x.size)
    # mix the slot to DC (the mixer's exact rational frequency)
    x = x * np.exp(-2j * np.pi * (2 * slot - b + 1) / (2 * b) * m)
    if b > 1:
        # anti-alias low-pass before decimation: Kaiser sinc at the slot
        # bandwidth (cutoff 3.1 MHz of R/2 = b*3 MHz)
        n_taps = 24 * b + 1
        t = np.arange(n_taps) - n_taps // 2
        cut = 3.1e6 / (b * SLOT_HZ / 2)      # normalized to Nyquist
        h = np.sinc(cut * t) * np.kaiser(n_taps, 10.0) * cut
        x = np.convolve(x, h)[n_taps // 2 : n_taps // 2 + x.size]
    # R -> fs: output n sits at input position n * 286*b/513, through the
    # receiver's polyphase interpolator (the low-pass above limited the band)
    return resample_stream(x[None], (RESAMPLE_UP * b) / RESAMPLE_DOWN)[0]
