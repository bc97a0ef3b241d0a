"""Host-side IO: pluggable sources, WAV writing, in-place header patching.

Equivalent of the reference's IO-callback vtable and stdio backend
(`/root/reference/src/libacm.h:52-69`, `util.c:58-115`) plus the CLI's WAV
writer and header patcher (`acmtool.c:193-229, 322-362`). The reference's
plugin use-cases (player VFS layers injecting custom IO) are covered by the
``AcmIO`` duck-typed protocol: anything with a ``read`` method works;
``seek``/``close``/``length`` are optional and their *presence* drives the
same capability semantics as the C vtable (e.g. no ``length`` ⇒ stream
reports non-seekable and the 13000 bps bitrate fallback kicks in).
"""

from __future__ import annotations

import io as _stdio
import os
import struct
from typing import Protocol, runtime_checkable

from .format import ACM_WORD, AcmError, AcmException


@runtime_checkable
class AcmIO(Protocol):
    """Duck-typed analog of `acm_io_callbacks` (libacm.h:52-69)."""

    def read(self, size: int = -1) -> bytes: ...

    # Optional (checked with hasattr, like NULL vtable slots in the C):
    # def seek(self, offset: int, whence: int = 0) -> int: ...
    # def close(self) -> None: ...
    # def length(self) -> int: ...


class FileSource:
    """stdio-style backend over a real file (util.c:58-91)."""

    def __init__(self, path: str | os.PathLike):
        try:
            self._f = open(path, "rb")
        except OSError as e:
            raise AcmException(AcmError.ERR_OPEN, str(e)) from e

    def read(self, size: int = -1) -> bytes:
        return self._f.read(size)

    def seek(self, offset: int, whence: int = 0) -> int:
        return self._f.seek(offset, whence)

    def close(self) -> None:
        self._f.close()

    def length(self) -> int:
        pos = self._f.tell()
        end = self._f.seek(0, 2)
        self._f.seek(pos)
        return end


class BytesSource:
    """In-memory source (plugin-style custom IO made trivial)."""

    def __init__(self, data: bytes):
        self._b = _stdio.BytesIO(data)
        self._len = len(data)

    def read(self, size: int = -1) -> bytes:
        return self._b.read(size)

    def seek(self, offset: int, whence: int = 0) -> int:
        return self._b.seek(offset, whence)

    def length(self) -> int:
        return self._len


def slurp(src: AcmIO) -> bytes:
    """Drain a source to EOF (the batch front-end consumes whole streams)."""
    chunks = []
    while True:
        c = src.read(64 * 1024)
        if not c:
            break
        chunks.append(c)
    return b"".join(chunks)


# ---------------------------------------------------------------------------
# WAV writing (acmtool.c:193-229 — canonical 44-byte RIFF/fmt16/data header)
# ---------------------------------------------------------------------------


def wav_header(pcm_total: int, channels: int, rate: int) -> bytes:
    """The exact 44 bytes the reference CLI writes."""
    datalen = pcm_total * ACM_WORD * channels
    avg_bps = rate * channels * ACM_WORD
    bits = ACM_WORD * 8
    block_align = bits * channels // 8
    hdrlen = 16
    wavlen = 4 + 8 + hdrlen + 8 + datalen
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", wavlen & 0xFFFFFFFF),
            b"WAVEfmt ",
            struct.pack("<IHHIIHH", hdrlen, 1, channels, rate, avg_bps,
                        block_align, bits),
            b"data",
            struct.pack("<I", datalen & 0xFFFFFFFF),
        ]
    )


def read_wav(data: bytes) -> tuple[int, int, "object"]:
    """Minimal RIFF/WAVE reader for the encoder: (channels, rate, int16 pcm).

    Accepts canonical PCM16 files (like the ones acmtool -d writes);
    rejects other formats with ValueError.
    """
    import numpy as np

    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            tag, channels, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            if tag != 1 or bits != 16:
                raise ValueError("only PCM16 WAV is supported")
            fmt = (channels, rate)
        elif cid == b"data":
            pcm = np.frombuffer(body[: size - (size % 2)], dtype="<i2")
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    return fmt[0], fmt[1], pcm


# ---------------------------------------------------------------------------
# In-place channel retag (acmtool -M/-S; acmtool.c:322-362)
# ---------------------------------------------------------------------------

_ACM_MAGIC_BYTES = bytes([0x97, 0x28, 0x03, 0x01])


def set_channels(path: str | os.PathLike, n_chan: int) -> None:
    """Patch the 16-bit channel field (byte 8) of a plain ACM header.

    Refuses non-ACM files and suspicious existing channel counts, matching
    the reference tool. Raises AcmException on refusal.
    """
    with open(path, "rb+") as f:
        hdr = f.read(14)
        if len(hdr) != 14:
            raise AcmException(AcmError.ERR_READ_ERR, "cannot read header")
        if hdr[:4] != _ACM_MAGIC_BYTES:
            raise AcmException(AcmError.ERR_NOT_ACM, "not an ACM file")
        oldnum = hdr[8] | (hdr[9] << 8)
        if oldnum not in (1, 2):
            raise AcmException(
                AcmError.ERR_OTHER, f"suspicios number of channels: {oldnum}"
            )
        patched = hdr[:8] + bytes([n_chan & 0xFF]) + hdr[9:]
        f.seek(0)
        f.write(patched)
