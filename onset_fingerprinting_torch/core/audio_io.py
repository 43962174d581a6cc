"""A copy of ``onset_fingerprinting_tpu.core.audio_io`` (no jax in it), with
only its imports changed.

Minimal WAV I/O (PCM 16/24/32-bit and IEEE float32), numpy in/out.

Native replacement for the reference's soundfile dependency (data.py:9,
realtime/recording.py:6) — stdlib + numpy only, since this framework targets
hermetic TPU hosts.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 array of shape [N] or [N, C], sample rate).

    Integer PCM is scaled to [-1, 1) like soundfile's float32 output.
    """
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and size >= 26:
                sub = struct.unpack_from("<H", body, 24)[0]
                fmt = (sub,) + fmt[1:]
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    wformat, channels, sr, _, _, bits = fmt
    if wformat == _WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif wformat == _WAVE_FORMAT_PCM and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif wformat == _WAVE_FORMAT_PCM and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif wformat == _WAVE_FORMAT_PCM and bits == 24:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        i = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i = np.where(i & 0x800000, i - 0x1000000, i)
        x = i.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"{path}: unsupported WAV format {wformat}/{bits}bit")
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, sr


def write_wav(
    path: str | Path, x: np.ndarray, sr: int, subtype: str = "float32"
) -> None:
    """Write float array as WAV.  ``subtype``: 'float32' or 'pcm16'."""
    x = np.asarray(x)
    channels = 1 if x.ndim == 1 else x.shape[1]
    if subtype == "float32":
        payload = x.astype("<f4").tobytes()
        wformat, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    elif subtype == "pcm16":
        payload = (
            np.clip(x, -1.0, 1.0 - 1.0 / 32768) * 32768.0
        ).astype("<i2").tobytes()
        wformat, bits = _WAVE_FORMAT_PCM, 16
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    byte_rate = sr * channels * bits // 8
    block_align = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, wformat, channels, sr, byte_rate, block_align, bits
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    Path(path).write_bytes(hdr + payload)
