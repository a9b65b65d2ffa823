"""ctypes bindings for the native tsio runtime, with build-on-first-use and
a pure-Python fallback so the package works without a toolchain.

The port's own copy of atsc_tpu/runtime/io.py (TsReader, IqSink,
phasor_replay_native and the UDP fallback; the SDR source and sink are not
ported yet). The native path keeps TS ingestion and IQ emission on C++
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
