"""GPMF (GoPro Metadata Format) parser: gyro and accelerometer streams.

The port's own copy of ``video_annotator_tpu/io/gpmf.py`` (numpy and
``struct`` only; host code). A pure-Python KLV parser, telemetry being
about a kilobyte per second: walk GPMF nodes, find ``STRM`` containers
with ``GYRO`` or ``ACCL`` payloads, apply ``SCAL`` scaling, and
interpolate per-sample timestamps across each packet. It feeds
``smoothing/gyro.py::integrate_gyro``.

GPMF KLV layout: 4-byte FourCC key, 1-byte type char, 1-byte sample size,
2-byte big-endian repeat count, then ``size*repeat`` payload bytes padded to
4-byte alignment. Type 0x00 marks a nested container.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from video_annotator_tpu_torch.io.mp4 import find_gpmf_track, read_track_samples

_TYPE_FMT = {
    ord("b"): "b", ord("B"): "B", ord("s"): "h", ord("S"): "H",
    ord("l"): "i", ord("L"): "I", ord("f"): "f", ord("d"): "d",
    ord("j"): "q", ord("J"): "Q",
}


def iter_klv(buf: bytes, start: int = 0, end: Optional[int] = None):
    """Yield (fourcc, type_char, sample_size, repeat, payload_start, payload_end)."""
    end = len(buf) if end is None else end
    pos = start
    while pos + 8 <= end:
        key = buf[pos : pos + 4]
        typ = buf[pos + 4]
        size = buf[pos + 5]
        repeat = struct.unpack_from(">H", buf, pos + 6)[0]
        payload = size * repeat
        ps = pos + 8
        pe = ps + payload
        if pe > end:
            return
        yield key, typ, size, repeat, ps, pe
        pos = ps + ((payload + 3) & ~3)


def _decode_array(buf: bytes, typ: int, size: int, repeat: int, ps: int):
    fmt = _TYPE_FMT.get(typ)
    if fmt is None:
        return None
    unit = struct.calcsize(fmt)
    per_sample = size // unit
    count = repeat * per_sample
    vals = struct.unpack_from(f">{count}{fmt}", buf, ps)
    arr = np.asarray(vals, np.float64)
    return arr.reshape(repeat, per_sample) if per_sample > 1 else arr


@dataclasses.dataclass
class GyroPacket:
    samples: np.ndarray  # (N, 3) raw sensor axis order (scaled to SI)
    timestamp: float  # packet start time (seconds)


def parse_sensor_packet(
    payload: bytes, timestamp: float, fourcc: bytes = b"GYRO"
) -> List[GyroPacket]:
    """Extract one sensor stream's samples (scaled by SCAL) from a payload.

    ``fourcc`` selects the stream: ``GYRO`` (rad/s) or ``ACCL`` (m/s^2) —
    the two streams the reference's dead code walked
    (``opencv/gpmf.cpp:82-105``).
    """
    packets: List[GyroPacket] = []

    # Real GPMF nests <= ~4 deep (DEVC > STRM > ...); a corrupt file
    # whose bytes encode a container-per-8-bytes chain must degrade to
    # "no packets", not blow the Python recursion limit.
    max_depth = 16

    def walk(start, end, depth=0):
        if depth >= max_depth:
            return
        scal: Optional[np.ndarray] = None
        for key, typ, size, repeat, ps, pe in iter_klv(payload, start, end):
            if typ == 0:  # nested container (DEVC / STRM)
                walk(ps, pe, depth + 1)
            elif key == b"SCAL":
                scal = _decode_array(payload, typ, size, repeat, ps)
            elif key == fourcc:
                arr = _decode_array(payload, typ, size, repeat, ps)
                if arr is None or arr.ndim != 2 or arr.shape[1] != 3:
                    continue
                if scal is not None:
                    s = np.asarray(scal, np.float64).reshape(-1)
                    arr = arr / (s if s.size in (1, 3) else s[:1])
                packets.append(GyroPacket(arr, timestamp))

    walk(0, len(payload))
    return packets


def parse_gyro_packet(payload: bytes, timestamp: float) -> List[GyroPacket]:
    """Extract GYRO samples (scaled by SCAL) from one GPMF payload."""
    return parse_sensor_packet(payload, timestamp, b"GYRO")


# GoPro gyro sample axis order is (z, x, y) in the camera's IMU frame; map
# into the camera frame used by the vision pipeline (x right, y down,
# z forward). This default matches HERO4/5-era firmware; override per rig.
DEFAULT_AXIS_MAP = ((1, 1.0), (2, -1.0), (0, -1.0))


def gyro_to_camera(samples: np.ndarray, axis_map=DEFAULT_AXIS_MAP) -> np.ndarray:
    """(N, 3) raw sensor samples -> (N, 3) camera-frame angular rates."""
    out = np.empty_like(samples)
    for i, (src, sign) in enumerate(axis_map):
        out[:, i] = samples[:, src] * sign
    return out


def extract_imu(path: str, fourccs=(b"GYRO", b"ACCL"),
                axis_map=None, tail_hz=(400.0, 200.0)):
    """One container walk -> {fourcc: (samples, timestamps) or None}.

    Reads the MET track and KLV-walks each payload ONCE for all requested
    streams (``extract_gyro``/``extract_accl`` each re-walk the file; the
    gravity estimator needs both).
    """
    axis_map = axis_map or DEFAULT_AXIS_MAP
    track = find_gpmf_track(path)
    if track is None:
        raise ValueError(f"no GoPro MET track in {path}")

    vals: Dict[bytes, List[np.ndarray]] = {f: [] for f in fourccs}
    tss: Dict[bytes, List[np.ndarray]] = {f: [] for f in fourccs}
    samples = list(read_track_samples(path, track))
    for i, (payload, ts) in enumerate(samples):
        next_ts = samples[i + 1][1] if i + 1 < len(samples) else None
        for fourcc, hz in zip(fourccs, tail_hz):
            for pkt in parse_sensor_packet(payload, ts, fourcc):
                n = pkt.samples.shape[0]
                if next_ts is not None and next_ts > ts:
                    t = ts + (next_ts - ts) * np.arange(n) / max(n, 1)
                else:
                    t = ts + np.arange(n) / hz
                vals[fourcc].append(gyro_to_camera(pkt.samples, axis_map))
                tss[fourcc].append(t)
    return {
        f: (np.concatenate(vals[f]), np.concatenate(tss[f]))
        if vals[f]
        else None
        for f in fourccs
    }


def _extract_stream(path: str, fourcc: bytes, axis_map, tail_hz: float):
    out = extract_imu(path, (fourcc,), axis_map, (tail_hz,))[fourcc]
    if out is None:
        raise ValueError(
            f"GoPro MET track has no {fourcc.decode()} stream in {path}"
        )
    return out


def extract_gyro(path: str, axis_map=DEFAULT_AXIS_MAP):
    """(omega (S, 3) rad/s camera-frame, timestamps (S,) seconds) from an MP4.

    Per-sample timestamps are interpolated across each packet's duration
    (the design sketched in ``opencv/gpmf.cpp:82-105``).
    """
    return _extract_stream(path, b"GYRO", axis_map, tail_hz=400.0)


def extract_accl(path: str, axis_map=DEFAULT_AXIS_MAP):
    """(accel (S, 3) m/s^2 camera-frame, timestamps (S,) seconds) from an MP4.

    The ACCL stream the reference's dead code also walked
    (``opencv/gpmf.cpp:82-105``); GoPro ACCL shares the GYRO sensor axis
    order, and linear accelerations transform into the camera frame with
    the same (proper) axis rotation. ~200 Hz on HERO-era firmware.
    """
    return _extract_stream(path, b"ACCL", axis_map, tail_hz=200.0)


# --- writer (tests / synthetic footage) ------------------------------------


def build_gpmf_payload(
    gyro: np.ndarray,
    scale: int = 939,
    accl: Optional[np.ndarray] = None,
    accl_scale: int = 418,
) -> bytes:
    """Serialize a minimal DEVC payload with SCAL+GYRO (and optionally a
    second STRM with SCAL+ACCL), int16 samples — enough structure to
    exercise the parser's container walk."""

    def klv(key: bytes, typ: int, size: int, repeat: int, payload: bytes) -> bytes:
        head = key + bytes([typ, size]) + struct.pack(">H", repeat)
        pad = (-len(payload)) % 4
        return head + payload + b"\x00" * pad

    def strm(fourcc: bytes, data: np.ndarray, s: int) -> bytes:
        raw = np.clip(np.round(data * s), -32768, 32767).astype(">i2")
        data_klv = klv(fourcc, ord("s"), 6, raw.shape[0], raw.tobytes())
        scal_klv = klv(b"SCAL", ord("s"), 2, 1, struct.pack(">h", s))
        body = scal_klv + data_klv
        return klv(b"STRM", 0, 1, len(body), body)

    streams = strm(b"GYRO", gyro, scale)
    if accl is not None:
        streams += strm(b"ACCL", accl, accl_scale)
    devc = klv(b"DEVC", 0, 1, len(streams), streams)
    return devc
