"""Minimal MP4 (ISO-BMFF) box parser: locate and read metadata track samples.

The port's own copy of ``video_annotator_tpu/io/mp4.py`` (``struct``
only; host code). OpenCV's reader exposes only video, so this module
walks the MP4 box tree directly: enough structure (moov/trak/mdia/hdlr
and the stbl sample tables) to pull every sample of the GoPro metadata
track (handler name "\\tGoPro MET") with timestamps, which is all GPMF
extraction needs; and the inverse, which writes such a track.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

_CONTAINERS = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"udta", b"dinf",
}


def _iter_boxes(buf: memoryview, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, pos)
        header = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, pos + 8)[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header or pos + size > end:
            return
        yield typ, pos + header, pos + size
        pos += size


@dataclasses.dataclass
class Mp4Track:
    handler_type: bytes
    handler_name: str
    timescale: int
    sample_sizes: List[int]
    sample_offsets: List[int]
    sample_times: List[float]  # seconds, decode timestamps


def _parse_stts(buf, s, e, timescale):
    count = struct.unpack_from(">I", buf, s + 4)[0]
    times = []
    t = 0
    for i in range(count):
        n, delta = struct.unpack_from(">II", buf, s + 8 + i * 8)
        for _ in range(n):
            times.append(t / timescale)
            t += delta
    return times


def _parse_stbl(buf, s, e, timescale):
    sizes: List[int] = []
    chunk_offsets: List[int] = []
    stsc: List[Tuple[int, int]] = []  # (first_chunk, samples_per_chunk)
    times: List[float] = []
    for typ, bs, be in _iter_boxes(buf, s, e):
        if typ == b"stsz":
            sample_size, count = struct.unpack_from(">II", buf, bs + 4)
            if sample_size:
                sizes = [sample_size] * count
            else:
                sizes = list(
                    struct.unpack_from(f">{count}I", buf, bs + 12)
                )
        elif typ == b"stco":
            count = struct.unpack_from(">I", buf, bs + 4)[0]
            chunk_offsets = list(struct.unpack_from(f">{count}I", buf, bs + 8))
        elif typ == b"co64":
            count = struct.unpack_from(">I", buf, bs + 4)[0]
            chunk_offsets = list(struct.unpack_from(f">{count}Q", buf, bs + 8))
        elif typ == b"stsc":
            count = struct.unpack_from(">I", buf, bs + 4)[0]
            for i in range(count):
                first, spc, _desc = struct.unpack_from(
                    ">III", buf, bs + 8 + i * 12
                )
                stsc.append((first, spc))
        elif typ == b"stts":
            times = _parse_stts(buf, bs, be, timescale)

    # Resolve per-sample file offsets from the chunk map.
    offsets: List[int] = []
    if chunk_offsets:
        n_chunks = len(chunk_offsets)
        spc_per_chunk = []
        for ci in range(1, n_chunks + 1):
            spc = 1
            for first, s_per_c in stsc:
                if ci >= first:
                    spc = s_per_c
            spc_per_chunk.append(spc)
        si = 0
        for ci, coff in enumerate(chunk_offsets):
            off = coff
            for _ in range(spc_per_chunk[ci]):
                if si >= len(sizes):
                    break
                offsets.append(off)
                off += sizes[si]
                si += 1
    return sizes, offsets, times


def _read_moov(path: str) -> Optional[bytes]:
    """The moov box payload, found by walking top-level box HEADERS with
    seeks — reading the whole file (GoPro chapters run to ~4 GB) just to
    parse a few hundred KB of moov would spike RSS by the file size."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        fsize = f.tell()
        pos = 0
        while pos + 8 <= fsize:
            f.seek(pos)
            hdr = f.read(16)
            if len(hdr) < 8:
                return None
            size, typ = struct.unpack_from(">I4s", hdr, 0)
            header = 8
            if size == 1:
                if len(hdr) < 16:
                    return None
                size = struct.unpack_from(">Q", hdr, 8)[0]
                header = 16
            elif size == 0:
                size = fsize - pos
            if size < header or pos + size > fsize:
                return None
            if typ == b"moov":
                f.seek(pos + header)
                return f.read(size - header)
            pos += size
    return None


def parse_tracks(path: str) -> List[Mp4Track]:
    moov = _read_moov(path)
    tracks: List[Mp4Track] = []
    if moov is None:
        return tracks
    buf = memoryview(moov)
    for t2, s2, e2 in _iter_boxes(buf, 0, len(buf)):
        if t2 != b"trak":
            continue
        handler_type = b""
        handler_name = ""
        timescale = 1000
        stbl = None
        for t3, s3, e3 in _iter_boxes(buf, s2, e2):
            if t3 != b"mdia":
                continue
            for t4, s4, e4 in _iter_boxes(buf, s3, e3):
                if t4 == b"mdhd":
                    version = buf[s4]
                    timescale = struct.unpack_from(
                        ">I", buf, s4 + (20 if version == 1 else 12)
                    )[0]
                elif t4 == b"hdlr":
                    handler_type = bytes(buf[s4 + 8 : s4 + 12])
                    name = bytes(buf[s4 + 24 : e4])
                    handler_name = name.split(b"\x00")[0].decode(
                        "utf-8", "replace"
                    )
                elif t4 == b"minf":
                    for t5, s5, e5 in _iter_boxes(buf, s4, e4):
                        if t5 == b"stbl":
                            stbl = (s5, e5)
        if stbl is None:
            continue
        sizes, offsets, times = _parse_stbl(buf, *stbl, timescale)
        tracks.append(
            Mp4Track(handler_type, handler_name, timescale, sizes, offsets, times)
        )
    return tracks


GOPRO_MET_HANDLER = "\tGoPro MET"  # src/join.ts:56-58


def find_gpmf_track(path: str) -> Optional[Mp4Track]:
    """The GoPro metadata track, identified like the reference does."""
    for track in parse_tracks(path):
        if track.handler_type == b"meta" and "GoPro MET" in track.handler_name:
            return track
    return None


def read_track_samples(path: str, track: Mp4Track):
    """Yield (payload_bytes, timestamp_seconds) per sample."""
    with open(path, "rb") as f:
        for size, off, ts in zip(
            track.sample_sizes, track.sample_offsets, track.sample_times
        ):
            f.seek(off)
            yield f.read(size), ts


# --- writing: inject a GoPro MET track --------------------------------------


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), typ) + payload


def _full(typ: bytes, payload: bytes) -> bytes:
    return _box(typ, b"\x00\x00\x00\x00" + payload)


def build_gpmf_trak(payloads: List[bytes], offsets: List[int],
                    timescale: int, delta: int, track_id: int) -> bytes:
    """A 'meta'/GoPro MET trak box over samples at absolute ``offsets``."""
    n = len(payloads)
    stsz = _full(
        b"stsz",
        struct.pack(">II", 0, n)
        + b"".join(struct.pack(">I", len(p)) for p in payloads),
    )
    stco = _full(b"stco", struct.pack(">I", n) + b"".join(
        struct.pack(">I", o) for o in offsets))
    stsc = _full(b"stsc", struct.pack(">I", 1) + struct.pack(">III", 1, 1, 1))
    stts = _full(b"stts", struct.pack(">I", 1) + struct.pack(">II", n, delta))
    # 16-byte generic 'gpmd' sample entry, as in real GoPro files.
    gpmd = struct.pack(">I4s", 16, b"gpmd") + b"\x00" * 6 + struct.pack(">H", 1)
    stsd = _full(b"stsd", struct.pack(">I", 1) + gpmd)
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
    minf = _box(b"minf", stbl)
    hdlr = _full(
        b"hdlr",
        b"\x00\x00\x00\x00" + b"meta" + b"\x00" * 12
        + GOPRO_MET_HANDLER.encode() + b"\x00",
    )
    mdhd = _full(
        b"mdhd",
        struct.pack(">IIII", 0, 0, timescale, n * delta)
        + struct.pack(">HH", 0, 0),
    )
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(
        b"tkhd",
        struct.pack(">IIIII", 0, 0, track_id, 0, n * delta) + b"\x00" * 60,
    )
    return _box(b"trak", tkhd + mdia)


def mux_gpmf_track(video_path: str, payloads: List[bytes], out_path: str,
                   timescale: int = 1000, delta: int = 1001) -> None:
    """Inject a GoPro MET telemetry track into an existing MP4.

    The inverse of the reference's demux side: makes a GoPro-shaped file
    (video + GPMF track) from any MP4 plus raw GPMF payloads (one sample
    per ``delta/timescale`` seconds — real GoPros write ~1 Hz packets).
    Box surgery: the telemetry mdat is appended after the original boxes
    and the new trak is spliced into moov, so existing sample offsets
    stay valid. Requires moov to be the last top-level box (true for
    every writer here: cv2 and libavformat both write moov at EOF
    without faststart).
    """
    with open(video_path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    boxes = list(_iter_boxes(buf, 0, len(buf)))
    if not boxes or boxes[-1][0] != b"moov":
        raise ValueError(
            f"{video_path}: moov is not the last top-level box; "
            "re-mux without faststart first"
        )
    moov_payload_s, moov_end = boxes[-1][1], boxes[-1][2]
    moov_off = moov_payload_s - 8  # header start (32-bit size assumed)
    if struct.unpack_from(">I4s", buf, moov_off)[1] != b"moov":
        raise ValueError(f"{video_path}: unsupported 64-bit moov header")
    pre = data[:moov_off]

    # New mdat directly after the original non-moov boxes.
    mdat_payload = b"".join(payloads)
    sample0 = len(pre) + 8
    offsets = []
    off = sample0
    for p in payloads:
        offsets.append(off)
        off += len(p)
    mdat = _box(b"mdat", mdat_payload)

    # Next free track id: max tkhd id + 1.
    track_id = 1
    for t2, s2, e2 in _iter_boxes(buf, moov_payload_s, moov_end):
        if t2 != b"trak":
            continue
        for t3, s3, e3 in _iter_boxes(buf, s2, e2):
            if t3 == b"tkhd":
                version = buf[s3]
                tid = struct.unpack_from(
                    ">I", buf, s3 + (20 if version == 1 else 12)
                )[0]
                track_id = max(track_id, tid + 1)
    trak = build_gpmf_trak(payloads, offsets, timescale, delta, track_id)

    old_moov = data[moov_off:]
    new_moov = (
        struct.pack(">I", len(old_moov) + len(trak))
        + old_moov[4:]
        + trak
    )
    with open(out_path, "wb") as f:
        f.write(pre + mdat + new_moov)


def write_gpmf_mp4(path: str, payloads: List[bytes], timescale: int = 1000,
                   delta: int = 1001) -> None:
    """Write a telemetry-only MP4: ``ftyp``, one ``mdat`` of the GPMF
    ``payloads`` and a ``moov`` with a single GoPro MET track over them
    (one sample per ``delta / timescale`` seconds). No video track: what
    ``render --gyro -a`` needs and nothing more. ``moov`` is the last box,
    so :func:`mux_gpmf_track` accepts the file too."""
    ftyp = _box(b"ftyp", b"isom\x00\x00\x02\x00isomiso2")
    offsets = []
    off = len(ftyp) + 8  # file offset of the first sample
    for p in payloads:
        offsets.append(off)
        off += len(p)
    mdat = _box(b"mdat", b"".join(payloads))
    duration = len(payloads) * delta
    # Valid movie header: a timescale and a duration.
    mvhd = _full(b"mvhd", struct.pack(">IIII", 0, 0, timescale, duration)
                 + b"\x00" * 80)
    trak = build_gpmf_trak(payloads, offsets, timescale, delta, track_id=1)
    with open(path, "wb") as f:
        f.write(ftyp + mdat + _box(b"moov", mvhd + trak))
