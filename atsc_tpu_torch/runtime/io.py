"""ctypes bindings for the native tsio runtime, with build-on-first-use and
a pure-Python fallback so the package works without a toolchain.

The port's own copy of atsc_tpu/runtime/io.py (TsReader, IqSink,
phasor_replay_native, the UDP fallback, and the SoapySDR sink and
source). The native path keeps TS ingestion and IQ emission on C++
threads (no GIL), with ring-buffer back-pressure mirroring the reference's
blocking fread/writeStream loop (reference util/atsc_encoder.cpp:83-101).

csrc/tsio.cpp is built with g++ at first use into the package's
git-ignored _build/ directory, named by a hash of the source and flags, so
an edited source builds anew and nothing is written beside the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "tsio.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
# -ffp-contract=off: phasor_replay must round like numpy's complex64 multiply
_GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
              "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library_path() -> str:
    digest = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(_BUILD_DIR, f"libtsio-{digest.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    """g++ the runtime into `so` (atomically: a concurrent build sees all
    or none); False when there is no working toolchain."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="libtsio-", suffix=".so.tmp", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_GXX_FLAGS, _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        lib = ctypes.CDLL(so)
        lib.ts_reader_open.restype = ctypes.c_void_p
        lib.ts_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.ts_reader_read.restype = ctypes.c_size_t
        lib.ts_reader_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        lib.ts_reader_eof.restype = ctypes.c_int
        lib.ts_reader_eof.argtypes = [ctypes.c_void_p]
        lib.ts_reader_bytes.restype = ctypes.c_uint64
        lib.ts_reader_bytes.argtypes = [ctypes.c_void_p]
        lib.ts_reader_close.argtypes = [ctypes.c_void_p]
        lib.iq_sink_open.restype = ctypes.c_void_p
        lib.iq_sink_open.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_double]
        lib.iq_sink_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.iq_sink_write_planar.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t]
        lib.iq_sink_bytes.restype = ctypes.c_uint64
        lib.iq_sink_bytes.argtypes = [ctypes.c_void_p]
        lib.iq_sink_close.argtypes = [ctypes.c_void_p]
        lib.phasor_replay.restype = None
        lib.phasor_replay.argtypes = [
            ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def phasor_replay_native(scale: complex, k: int) -> complex | None:
    """Replay k float32 phasor-recurrence steps in the native runtime
    (~4 ms at k = 1e6 vs ~1 s for the Python scalar loop) — or None when
    the library is unavailable. The caller (tables/oscillator.py) verifies
    bit-identity against the numpy replay once per process before
    trusting it."""
    lib = _load()
    if lib is None:
        return None
    out = (ctypes.c_float * 2)()
    lib.phasor_replay(ctypes.c_float(scale.real), ctypes.c_float(scale.imag),
                      ctypes.c_uint64(k), out)
    return complex(np.complex64(out[0] + 1j * out[1]))


def _rtp_strip(dgram: bytes) -> bytes:
    """Strip an RTP wrap (RFC 3550 / SMPTE 2022-2) if present: version-2
    header followed by a 0x47-aligned n*188 TS payload."""
    if len(dgram) >= 13 and (dgram[0] >> 6) == 2:
        hdr = 12 + 4 * (dgram[0] & 0x0F)
        if (len(dgram) > hdr and dgram[hdr] == 0x47
                and (len(dgram) - hdr) % 188 == 0):
            return dgram[hdr:]
    return dgram


class _UdpTs:
    """Fallback 'udp://[group]:port' TS source (datagram-aligned, RTP
    auto-stripped) — same contract as the native socket path in tsio.cpp."""

    def __init__(self, spec: str):
        import socket

        host, _, port = spec.rpartition(":")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        mcast = False
        if host:
            first = int(host.split(".", 1)[0])
            mcast = 224 <= first <= 239
        self._sock.bind(("" if (not host or mcast) else host, int(port)))
        if mcast:
            import struct

            req = struct.pack("4s4s", socket.inet_aton(host),
                              socket.inet_aton("0.0.0.0"))
            self._sock.setsockopt(socket.IPPROTO_IP,
                                  socket.IP_ADD_MEMBERSHIP, req)
        self._pend = bytearray()
        self.name = f"udp://{spec}"

    def read(self, n: int) -> bytes:
        while len(self._pend) < n:
            self._pend.extend(_rtp_strip(self._sock.recv(65536)))
        out = bytes(self._pend[:n])
        del self._pend[:n]
        return out

    def close(self) -> None:
        self._sock.close()


class TsReader:
    """Aligned TS byte source. path '-' = stdin, 'udp://[group]:port' for
    a live UDP/RTP headend feed (multicast groups are joined)."""

    def __init__(self, path: str, ring_bytes: int = 8 << 20):
        lib = _load()
        self._lib = lib
        self._h = None
        if lib is not None:
            h = lib.ts_reader_open(path.encode(), ring_bytes)
            if not h:
                raise FileNotFoundError(path)
            self._h = ctypes.c_void_p(h)
        elif path.startswith("udp://"):
            self._fp = _UdpTs(path[len("udp://"):])
        else:  # pure-Python fallback
            self._fp = sys.stdin.buffer if path == "-" else open(path, "rb")

    def read(self, n: int, blocking: bool = True) -> bytes:
        """Read up to n bytes; b'' on EOF."""
        if self._h is not None:
            buf = (ctypes.c_uint8 * n)()
            got = self._lib.ts_reader_read(self._h, buf, n, 1 if blocking else 0)
            return bytes(buf[:got])
        data = self._fp.read(n)
        return data or b""

    def eof(self) -> bool:
        if self._h is not None:
            return bool(self._lib.ts_reader_eof(self._h))
        return False

    def close(self) -> None:
        if self._h is not None:
            self._lib.ts_reader_close(self._h)
            self._h = None
        elif getattr(self, "_fp", None) is not None:
            if self._fp.name != "<stdin>":
                self._fp.close()
            self._fp = None


class IqSink:
    """IQ byte sink: 'null', '-' (stdout) or a file path; optional pacing
    in bytes/s (e.g. SAMPLE_RATE * 8 for real-time CF32)."""

    def __init__(self, path: str = "null", ring_bytes: int = 64 << 20,
                 pace_bytes_per_sec: float = 0.0):
        lib = _load()
        self._lib = lib
        self._h = None
        self._bytes = 0
        if lib is not None:
            h = lib.iq_sink_open(path.encode(), ring_bytes, pace_bytes_per_sec)
            if not h:
                raise FileNotFoundError(path)
            self._h = ctypes.c_void_p(h)
        else:
            self._fp = (
                None if path == "null"
                else sys.stdout.buffer if path == "-" else open(path, "wb")
            )
            # without the native runtime the caller's thread paces itself,
            # as the native writer thread does: byte k leaves no earlier
            # than k / pace seconds after the open
            self._pace = pace_bytes_per_sec
            self._t0 = time.perf_counter()

    def write(self, arr: np.ndarray) -> None:
        data = np.ascontiguousarray(arr)
        if self._h is not None:
            self._lib.iq_sink_write(
                self._h, data.ctypes.data_as(ctypes.c_void_p), data.nbytes
            )
        elif self._fp is not None:
            self._fp.write(data.tobytes())
        self._bytes += data.nbytes
        if self._h is None and self._pace > 0:
            wait = self._t0 + self._bytes / self._pace - time.perf_counter()
            if wait > 0:
                time.sleep(wait)

    def write_planar(self, arr: np.ndarray, n_valid: int) -> None:
        """Planar (B, 2, stride>=n_valid) component array -> interleaved
        (B, n_valid, 2) wire bytes, interleaved natively off the GIL (the
        device emits planar IQ; the wire is the reference's interleaved
        complex layout, atsc.cpp:89). Falls back to a numpy transpose."""
        data = np.ascontiguousarray(arr)
        if self._h is not None and data.ndim == 3 and data.shape[1] == 2:
            elem = data.dtype.itemsize
            self._lib.iq_sink_write_planar(
                self._h, data.ctypes.data_as(ctypes.c_void_p), elem,
                data.shape[0], data.shape[2], n_valid,
            )
            self._bytes += data.shape[0] * n_valid * 2 * elem
            return
        self.write(
            np.ascontiguousarray(np.moveaxis(data[..., :n_valid], -2, -1))
        )

    def write_wire(self, arr: np.ndarray, n_valid: int) -> None:
        """Packed wire lanes (B, stride>=n_valid) — one little-endian
        (I, Q) pair per lane, as the offset+FIR kernel emits them with
        wire=True — written verbatim, channel by channel."""
        a = np.asarray(arr)
        if a.ndim == 1:
            a = a[None]
        for b in range(a.shape[0]):
            self.write(a[b, :n_valid])

    def bytes_written(self) -> int:
        if self._h is not None:
            return int(self._lib.iq_sink_bytes(self._h))
        return self._bytes

    def close(self) -> None:
        if self._h is not None:
            self._lib.iq_sink_close(self._h)
            self._h = None
        elif getattr(self, "_fp", None) is not None and self._fp.name != "<stdout>":
            self._fp.close()
            self._fp = None


_SOAPY_FORMAT = {"cf32": "CF32", "cs16": "CS16", "cs8": "CS8"}
_SAMPLE_DTYPE = {"cf32": np.float32, "cs16": np.int16, "cs8": np.int8}


def _soapy(direction: str, instead: str):
    """The SoapySDR module and its direction constant ('TX' or 'RX'), or a
    RuntimeError naming what to use instead when the bindings are absent."""
    try:
        import SoapySDR  # type: ignore
    except ImportError as e:
        raise RuntimeError("SoapySDR python bindings not available on this "
                           f"host; {instead}") from e
    return SoapySDR, getattr(SoapySDR, f"SOAPY_SDR_{direction}")


def _open_device(soapy, direction, driver: str, frequency_hz: float, gain_db: float,
                 sample_rate: float, stream_format: str, bandwidth_hz: float):
    """Open, configure (bandwidth, rate, frequency, gain: the reference's
    order), set up and activate one stream; (device, stream, MTU)."""
    sdr = soapy.Device({"driver": driver})
    sdr.setBandwidth(direction, 0, bandwidth_hz)
    sdr.setSampleRate(direction, 0, sample_rate)
    sdr.setFrequency(direction, 0, frequency_hz)
    sdr.setGain(direction, 0, gain_db)
    stream = sdr.setupStream(direction, _SOAPY_FORMAT[stream_format])
    sdr.activateStream(stream)
    return sdr, stream, int(sdr.getStreamMTU(stream))


class SoapySdrSink:
    """SDR transmit sink through SoapySDR (the reference's production
    output, util/atsc_encoder.cpp:60-101): the device set to the bandwidth
    (6 MHz), the sample rate (the 10.762238 MHz symbol rate unless given),
    the RF frequency and the gain, then a TX stream of the wire format
    written in MTU-sized chunks.

    Needs the optional `SoapySDR` python module; without it the constructor
    raises a RuntimeError, and the null and file sinks stay the default.
    The device's own clock paces the stream. Besides `write` it takes the
    IqSink calls the encode loop makes: planar (B, 2, m) components, and
    packed wire lanes (B, m), whose bytes are already the interleaved
    stream.
    """

    def __init__(self, driver: str = "hackrf", frequency_hz: float = 473e6,
                 gain_db: float = 54.0, sample_rate: float | None = None,
                 stream_format: str = "cf32",
                 bandwidth_hz: float = 6_000_000.0):
        soapy, tx = _soapy("TX", "use a 'null'/file/stdout sink instead")
        from atsc_tpu_torch import params as P

        self._np_dtype = _SAMPLE_DTYPE[stream_format]
        self._sdr, self._stream, self._mtu = _open_device(
            soapy, tx, driver, frequency_hz, gain_db, sample_rate or P.SAMPLE_RATE,
            stream_format, bandwidth_hz)
        self._bytes = 0

    def write(self, arr: np.ndarray) -> None:
        """arr: (..., n, 2) interleaved IQ samples in the stream's sample
        dtype (float32 CF32 / int16 CS16 / int8 CS8)."""
        flat = np.ascontiguousarray(arr, dtype=self._np_dtype).reshape(-1, 2)
        pos = 0
        while pos < flat.shape[0]:
            chunk = flat[pos : pos + self._mtu]
            ret = self._sdr.writeStream(self._stream, [chunk], chunk.shape[0])
            sent = getattr(ret, "ret", ret)
            if sent <= 0:
                raise IOError(f"SoapySDR writeStream returned {sent}")
            pos += sent
        self._bytes += flat.nbytes

    def write_planar(self, arr: np.ndarray, n_valid: int) -> None:
        """Planar (B, 2, stride >= n_valid) components, channel by channel."""
        self.write(np.moveaxis(np.asarray(arr)[..., :n_valid], -2, -1))

    def write_wire(self, arr: np.ndarray, n_valid: int) -> None:
        """Packed wire lanes (B, stride >= n_valid), one little-endian (I, Q)
        pair a lane: their bytes, channel by channel, are the samples."""
        lanes = np.ascontiguousarray(np.asarray(arr).reshape(-1, arr.shape[-1])[:, :n_valid])
        self.write(lanes.view(self._np_dtype))

    def bytes_written(self) -> int:
        return self._bytes

    def close(self) -> None:
        if getattr(self, "_stream", None) is not None:
            self._sdr.deactivateStream(self._stream)
            self._sdr.closeStream(self._stream)
            self._stream = None


class SoapySdrSource:
    """SDR receive source through SoapySDR, the capture side of the headend
    (SoapySdrSink's mirror). File-like for the decode CLI: `read(n)` blocks
    on the RX stream and returns exactly n wire bytes of interleaved (I, Q)
    samples in the requested format (CF32/CS16/CS8); `seekable()` is False.
    Timeouts are retried; overflows (samples the device dropped because the
    consumer fell behind) are counted in `.overflows`.

    Timestamped gap filling: when the driver stamps its buffers (`timeNs`
    with the HAS_TIME flag), a discontinuity is measured exactly and
    replaced with that many zero samples (from 8 up to `max_fill_samples`),
    so the receiver's sample-counting field tracker keeps the stream
    position; the zeroed span decodes as noise and RS absorbs what it can.
    `.gaps_filled` / `.gap_samples` count the events. Gaps without stamps,
    or larger ones, are left to the receiver's `resync="auto"`.

    Needs the optional `SoapySDR` python module, as the sink does.
    """

    def __init__(self, driver: str = "hackrf", frequency_hz: float = 473e6,
                 gain_db: float = 30.0, sample_rate: float | None = None,
                 stream_format: str = "cf32",
                 bandwidth_hz: float = 6_000_000.0,
                 max_fill_samples: int = 8 * 260_416):
        soapy, rx = _soapy("RX", "decode from a capture file instead")
        from atsc_tpu_torch import params as P

        self._timeout_code = getattr(soapy, "SOAPY_SDR_TIMEOUT", -1)
        self._overflow_code = getattr(soapy, "SOAPY_SDR_OVERFLOW", -2)
        self._has_time_flag = getattr(soapy, "SOAPY_SDR_HAS_TIME", 1 << 2)
        self._np_dtype = _SAMPLE_DTYPE[stream_format]
        self._sample_bytes = 2 * np.dtype(self._np_dtype).itemsize
        rate = sample_rate or P.SAMPLE_RATE
        self._sdr, self._stream, self._mtu = _open_device(
            soapy, rx, driver, frequency_hz, gain_db, rate, stream_format, bandwidth_hz)
        self._pending = b""
        self._bytes = 0
        self._rate = float(rate)
        self._expect_ns: float | None = None  # the next buffer's expected stamp
        self.max_fill_samples = max_fill_samples
        self.overflows = 0
        self.gaps_filled = 0
        self.gap_samples = 0

    def _gap_zeros(self, res, got: int) -> bytes:
        """Zero bytes for a timestamp discontinuity before this buffer (b''
        without stamps, or for a gap of 0, jitter or beyond the limit)."""
        # timeNs is defined only with HAS_TIME: a stale stamp without the
        # flag must not invent gaps
        flags = int(getattr(res, "flags", 0) or 0)
        t_ns = float(getattr(res, "timeNs", 0) or 0)
        if not (flags & self._has_time_flag) or t_ns <= 0.0:
            self._expect_ns = None
            return b""
        fill = b""
        if self._expect_ns is not None:
            gap = int(round((t_ns - self._expect_ns) * self._rate * 1e-9))
            # under 8 samples is stamp jitter, not a drop
            if 8 <= gap <= self.max_fill_samples:
                self.gaps_filled += 1
                self.gap_samples += gap
                fill = bytes(gap * self._sample_bytes)
        self._expect_ns = t_ns + got / self._rate * 1e9
        return fill

    def read(self, n: int = -1) -> bytes:
        """Blocking read of exactly n bytes (whole samples are buffered, so
        any n works). A live stream has no end: a read without a size is
        refused rather than looping forever."""
        if n < 0:
            raise ValueError("read() without a size on a live SDR stream would never "
                             "return; pass a byte count (or use --max-fields)")
        if self._stream is None:
            return b""  # closed: end of stream
        out = bytearray(self._pending)
        buf = np.empty((self._mtu, 2), self._np_dtype)
        while len(out) < n:
            want = min(self._mtu, -(-(n - len(out)) // self._sample_bytes))
            res = self._sdr.readStream(self._stream, [buf], want)
            got = getattr(res, "ret", res)
            if got == self._timeout_code:
                continue
            if got == self._overflow_code:
                self.overflows += 1
                continue
            if got < 0:
                raise IOError(f"SoapySDR readStream returned {got}")
            out += self._gap_zeros(res, got)
            out += buf[:got].tobytes()
        self._bytes += n
        self._pending = bytes(out[n:])
        return bytes(out[:n])

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return False

    def bytes_read(self) -> int:
        return self._bytes

    def close(self) -> None:
        if getattr(self, "_stream", None) is not None:
            self._sdr.deactivateStream(self._stream)
            self._sdr.closeStream(self._stream)
            self._stream = None
