"""Checkpoint/resume for encoder and receiver streams.

Counterpart of atsc_tpu/utils/checkpoint.py, in the same file format: one
.npz with the same keys, dtypes and version stamp, so a checkpoint that
the JAX package wrote resumes here and one written here loads in the JAX
package's load_state/load_receiver. The arrays are stored, not deflated
(np.savez, not savez_compressed; np.load reads either): at B=384 a
receiver's sample window is ~0.8 GB of float32 noise and the adaptive
normal equations another 0.4 GB, which deflate barely shrinks in many
times the time of a stored write (chip_smoke.py phase 29 times both on
the encoder's state). A save goes to a temporary file beside `path`
and is renamed over it, so a crash mid-save leaves the last good
checkpoint whole.

Encoder side: the O(1) EncoderState leaves plus the field counter, and an
`encode --mux` run's FdmMuxer carry or an `encode --rate` run's
StreamResampler state. Receiver side (save_receiver/load_receiver): an
IqReceiver's configuration, decode progress, the un-consumed sample
window, the decoder's interleaver/precoder/Viterbi state (hard, soft,
NTSC; chunked too), the carried erasure flags, RS statistics, the resync
and NTSC flags, and the adaptive backends' RLS normal equations, taps and
retrain cadence, so a decode stopped at any push boundary continues
byte-identically. Loads check every leaf's shape and dtype
(utils/convert.py) and place the state on the requested device. A
sharded receiver (parallel/rx_shard.py, decode --mesh) gathers its shards
into the full state for save_sharded_receiver, in the JAX package's
format too; an encode --mesh run saves its gathered EncoderState with
save_state.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from atsc_tpu_torch.models.encoder import EncoderState
from atsc_tpu_torch.utils import convert

_FIELDS = EncoderState._fields

#: bump when the on-disk layout changes incompatibly (leaf set, leaf
#: meaning, or metadata keys); loaders refuse any other version loudly
CHECKPOINT_VERSION = 1


def _check_version(z, path: str, kind: str) -> None:
    ver = int(z["__version__"]) if "__version__" in z else 0
    if ver != CHECKPOINT_VERSION:
        raise ValueError(
            f"{kind} checkpoint {path!r} has format version {ver}, but "
            f"this build reads version {CHECKPOINT_VERSION} — it was "
            "written by an incompatible build; re-run without --resume "
            "(version 0 = pre-versioning checkpoint)"
        )


def _write(path: str, arrays: dict) -> None:
    """np.savez to exactly `path` (no '.npz' appended), through a
    temporary file renamed over it."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_state(path: str, state: EncoderState, fields_encoded: int = 0,
               mux_carry: np.ndarray | None = None,
               resample_state: dict | None = None) -> None:
    """Persist an encoder stream: the state leaves, the field counter, and
    (encode --mux) the FdmMuxer carry or (encode --rate) the output-side
    StreamResampler.full_state()."""
    arrays = {name: _host(getattr(state, name)) for name in _FIELDS}
    arrays["__version__"] = np.asarray(CHECKPOINT_VERSION, dtype=np.int64)
    arrays["__fields_encoded__"] = np.asarray(fields_encoded, dtype=np.int64)
    if mux_carry is not None:
        arrays["__mux_carry__"] = np.asarray(mux_carry)
    if resample_state is not None:
        for k, v in resample_state.items():
            arrays[f"__rs_{k}__"] = np.asarray(v)
    _write(path, arrays)


def load_state(path: str, *, device: str | torch.device) -> tuple[EncoderState, int]:
    """Restore an encoder checkpoint onto `device`: (state, fields
    encoded). Fails loudly, never misloads, when the file was written by
    an incompatible build: the version stamp first, then every leaf
    against the shape and dtype init_state gives."""
    with np.load(path) as z:
        _check_version(z, path, "encoder")
        missing = [n for n in _FIELDS if n not in z.files]
        if missing:
            raise ValueError(
                f"encoder checkpoint {path!r} lacks state leaves {missing} — "
                "written by an incompatible build")
        leaves = {name: z[name] for name in _FIELDS}
        fields = int(z["__fields_encoded__"])
    try:
        state = convert.state_from_numpy(leaves, device)
    except ValueError as e:
        raise ValueError(f"encoder checkpoint {path!r}: {e} — the state layout "
                         "changed; cannot resume") from None
    return state, fields


def load_mux_carry(path: str) -> np.ndarray | None:
    """The FdmMuxer carry of an encode --mux checkpoint (None when the
    checkpoint was written by a plain single-stream run)."""
    with np.load(path) as z:
        return z["__mux_carry__"] if "__mux_carry__" in z.files else None


def load_resample_state(path: str) -> dict | None:
    """The output-side StreamResampler state of an encode --rate
    checkpoint (None for a nominal-rate run)."""
    with np.load(path) as z:
        keys = [k for k in z.files if k.startswith("__rs_")]
        return {k[len("__rs_"):-2]: z[k] for k in keys} if keys else None


# -- receiver checkpoints -----------------------------------------------

_RX_CONFIG = ("batch", "first_field", "backend", "trellis", "erasures",
              "wire_format", "eq_profile", "ntsc", "viterbi_chunks",
              "resync", "resync_after", "resync_threshold")


def save_receiver(path: str, rx, extra: dict | None = None,
                  extra_arrays: dict | None = None) -> None:
    """Persist an IqReceiver (models/receiver.py) mid-stream.

    extra: JSON-serializable caller metadata (the CLI's conditioning
    parameters), returned as `rx.checkpoint_extra` on load. extra_arrays:
    caller-owned numpy arrays (the --demux FdmDemuxer carry), returned as
    `rx.checkpoint_arrays` on load.
    """
    dec = rx.decoder
    st = dec.state
    arrays = {
        "extra_json": np.asarray(json.dumps(extra or {})),
        "__kind__": np.asarray("iq_receiver"),
        "__version__": np.asarray(CHECKPOINT_VERSION, dtype=np.int64),
        "config": np.asarray([str(getattr(rx, k)) for k in _RX_CONFIG], dtype=np.str_),
        "next_field": np.asarray(rx._next_field, dtype=np.int64),
        "primed": np.asarray(rx._primed),
        "epoch": np.asarray(rx._epoch, dtype=np.int64),
        "resync_state": np.asarray(
            [rx._bad_streak, rx._acquiring, rx._acquire_from, rx.resyncs],
            dtype=np.int64),
        "resync_log_json": np.asarray(json.dumps(rx.resync_log)),
        "fields_emitted": np.asarray(rx.fields_emitted, dtype=np.int64),
        "stream_base": np.asarray(rx._stream.base, dtype=np.int64),
        "stream_window": rx._stream.window(rx._stream.base, rx._stream.end),
        "dec_prev_il": _host(st.prev_il),
        "dec_z2_prev": _host(st.z2_prev),
        "rs_stats": np.asarray(
            [dec.segments_corrected, dec.segments_uncorrectable,
             dec.segments_erasure_assisted], dtype=np.int64),
        "ntsc_flags": np.asarray([rx._ntsc_pending, rx.ntsc_active]),
    }
    if hasattr(st, "metrics"):                  # soft / NTSC (Viterbi) decoder
        arrays["dec_metrics"] = _host(st.metrics)
    if dec.flag_il is not None:                 # erasure-flag carry
        arrays["dec_flag_il"] = _host(dec.flag_il)
    eq = rx.adaptive
    if eq is not None:                          # RLS normal equations
        ast = eq.state
        arrays["rls_r"] = _host(ast.r)
        arrays["rls_v"] = _host(ast.v)
        arrays["rls_lam"] = np.asarray(eq._lam, dtype=np.float32)
        arrays["rls_ridge"] = np.asarray(eq._ridge, dtype=np.float32)
        # the retrain cadence: the cached taps and the field counter keep a
        # resumed stream's solve schedule, and so its output, identical
        arrays["rls_cadence"] = np.asarray([eq.train_every, ast.fields_seen],
                                           dtype=np.int64)
        if ast.w is not None:
            arrays["rls_w"] = _host(ast.w)
    for name, arr in (extra_arrays or {}).items():
        arrays["xarr_" + name] = np.asarray(arr)
    _write(path, arrays)


def _opt(cfg: dict, key: str, default: str) -> str | None:
    val = cfg.get(key, default)
    return None if val == "None" else val


def load_receiver(path: str, *, device: str | torch.device):
    """Rebuild the checkpointed IqReceiver on `device`; decoding continues
    byte-identically from the saved push boundary."""
    from atsc_tpu_torch.models.receiver import IqReceiver

    with np.load(path) as npz:
        z = {k: npz[k] for k in npz.files}
    if str(z.get("__kind__", "")) != "iq_receiver":
        raise ValueError(f"{path!r} is not a receiver checkpoint")
    _check_version(z, path, "receiver")
    cfg = dict(zip(_RX_CONFIG, (str(s) for s in z["config"])))
    rx = IqReceiver(
        batch=int(cfg["batch"]), first_field=int(cfg["first_field"]),
        backend=cfg["backend"], trellis=cfg["trellis"],
        erasures=_opt(cfg, "erasures", "None"), wire_format=cfg["wire_format"],
        eq_profile=cfg["eq_profile"], ntsc=_opt(cfg, "ntsc", "None"),
        viterbi_chunks=int(cfg.get("viterbi_chunks", "1")),
        resync=_opt(cfg, "resync", "None"),
        resync_after=int(cfg.get("resync_after", "2")),
        resync_threshold=float(cfg.get("resync_threshold", "0.5")),
        device=device)
    if "epoch" in z:
        rx._epoch = int(z["epoch"])
        rs = z["resync_state"]
        rx._bad_streak = int(rs[0])
        rx._acquiring = bool(rs[1])
        rx._acquire_from = int(rs[2])
        rx.resyncs = int(rs[3])
        rx.resync_log = json.loads(str(z["resync_log_json"]))
    if "ntsc_flags" in z:
        rx._ntsc_pending = bool(z["ntsc_flags"][0])
        if bool(z["ntsc_flags"][1]) and not rx.ntsc_active:  # auto-detected comb
            rx.ntsc_active = True
            rx._decoder = rx._make_decoder()
    rx._next_field = int(z["next_field"])
    rx._primed = bool(z["primed"])
    rx.fields_emitted = (int(z["fields_emitted"]) if "fields_emitted" in z
                         else (max(rx._next_field - 1, 0) if rx._primed else 0))
    base, win = int(z["stream_base"]), z["stream_window"]
    stream = rx._stream
    if win.ndim != 3 or win.shape[:2] != (rx.batch, 2):
        raise ValueError(f"receiver checkpoint {path!r}: sample window {win.shape}, "
                         f"want ({rx.batch}, 2, n)")
    if win.shape[-1]:
        stream._chunks = [win.astype(stream.dtype, copy=False)]
        stream._starts = [base]
    stream.base = base
    stream.end = base + win.shape[-1]
    dec = rx.decoder
    leaves = {"prev_il": z["dec_prev_il"], "z2_prev": z["dec_z2_prev"]}
    if "dec_metrics" in z:
        leaves["metrics"] = z["dec_metrics"]
    from_numpy = {"DecoderState": convert.decoder_state_from_numpy,
                  "SoftDecoderState": convert.soft_decoder_state_from_numpy,
                  "NtscDecoderState": convert.ntsc_decoder_state_from_numpy}
    try:
        dec.state = from_numpy[type(dec.state).__name__](leaves, rx.device)
        if "dec_flag_il" in z:
            dec.flag_il = convert.flag_il_from_numpy(z["dec_flag_il"], rx.device)
        if rx.adaptive is not None:
            eq = rx.adaptive
            cad = z.get("rls_cadence", np.asarray([eq.train_every, 0]))
            eq.state = convert.adaptive_state_from_numpy(
                {"r": z["rls_r"], "v": z["rls_v"], "w": z.get("rls_w"),
                 "fields_seen": int(cad[1])}, rx.device)
            eq._lam = float(z["rls_lam"])
            eq._ridge = float(z["rls_ridge"])
            eq.train_every = rx.train_every = int(cad[0])
    except ValueError as e:
        raise ValueError(f"receiver checkpoint {path!r}: {e} — written by an "
                         "incompatible build; cannot resume") from None
    stats = z["rs_stats"]
    dec.segments_corrected = int(stats[0])
    dec.segments_uncorrectable = int(stats[1])
    dec.segments_erasure_assisted = int(stats[2])
    rx.checkpoint_extra = json.loads(str(z["extra_json"])) if "extra_json" in z else {}
    rx.checkpoint_arrays = {k[5:]: v for k, v in z.items() if k.startswith("xarr_")}
    return rx


# -- sharded (mesh) receiver checkpoints ----------------------------------

_SRX_CONFIG = ("batch", "trellis", "wire_format", "t_total", "n_time",
               "n_ch", "equalizer", "eq_profile")


def save_sharded_receiver(path: str, rx, extra: dict | None = None) -> None:
    """Persist a parallel/rx_shard.py ShardedReceiver between steps, its
    shards gathered into the full state on the host (every shard must be
    this process's). `extra` carries the CLI's stream-position metadata.
    The JAX package's keys, plus `train_every` (the adaptive retrain
    cadence), a key its restore_sharded_receiver does not read."""
    arrays = {
        "extra_json": np.asarray(json.dumps(extra or {})),
        "__kind__": np.asarray("sharded_receiver"),
        "__version__": np.asarray(CHECKPOINT_VERSION, dtype=np.int64),
        "config": np.asarray([str(getattr(rx, k)) for k in _SRX_CONFIG], dtype=np.str_),
        "next_field": np.asarray(rx._next_field, dtype=np.int64),
        "rs_stats": np.asarray([rx.segments_corrected, rx.segments_uncorrectable],
                               dtype=np.int64),
        "train_every": np.asarray(rx.train_every, dtype=np.int64),
    }
    state = rx.state
    for name in type(state)._fields:
        arrays["st_" + name] = np.asarray(getattr(state, name))
    _write(path, arrays)


def restore_sharded_receiver(path: str, rx) -> dict:
    """Restore a save_sharded_receiver checkpoint (either package's) into
    an already built ShardedReceiver, whose mesh and tier come from the
    caller and must match the file: every configuration key, the retrain
    cadence (1 where the file has none), and every leaf's shape and dtype.
    Returns the saved `extra` metadata."""
    with np.load(path) as npz:
        z = {k: npz[k] for k in npz.files}
    if str(z.get("__kind__", "")) != "sharded_receiver":
        raise ValueError(f"{path!r} is not a sharded-receiver checkpoint")
    _check_version(z, path, "sharded receiver")
    cfg = dict(zip(_SRX_CONFIG, (str(s) for s in z["config"])))
    cfg["train_every"] = str(int(z.get("train_every", 1)))
    for k, saved in cfg.items():
        if saved != str(getattr(rx, k)):
            raise ValueError(
                f"sharded-receiver checkpoint {path!r} was written with "
                f"{k}={saved}, but this decode runs {k}={getattr(rx, k)} — "
                "re-run with matching flags")
    want = rx.state
    leaves = {}
    for name in type(want)._fields:
        key = "st_" + name
        if key not in z:
            raise ValueError(f"sharded-receiver checkpoint {path!r} lacks state leaf "
                             f"{name!r} — written by an incompatible build")
        arr, w = z[key], getattr(want, name)
        if arr.shape != w.shape or arr.dtype != w.dtype:
            raise ValueError(
                f"sharded-receiver checkpoint {path!r} leaf {name!r} is "
                f"{arr.shape}/{arr.dtype} but this build expects "
                f"{w.shape}/{w.dtype} — cannot resume")
        leaves[name] = arr
    rx.set_state(type(want)(**leaves))
    rx._next_field = int(z["next_field"])
    rx.segments_corrected, rx.segments_uncorrectable = (int(v) for v in z["rs_stats"])
    return json.loads(str(z["extra_json"]))
