"""Format constants, header model and error taxonomy of InterPlay ACM / WAVC:
the benchmark's frozen copy, so that its plain reference imports nothing of
the program under test.

Every fact here follows the C reference libacm (markokr/libacm: src/libacm.h
lines 28-39, src/decode.c lines 685-752).
"""

from __future__ import annotations

import dataclasses
import enum

#: 24-bit magic at the start of every plain ACM stream (libacm.h:28).
ACM_ID = 0x032897
#: Sample word size in bytes; only 16-bit output exists (libacm.h:29).
ACM_WORD = 2
#: 24-bit magic of the WAVC wrapper: "WAV" little-endian (decode.c:685).
WAVC_ID = 0x564157

#: Plain ACM header length in bytes (util.c:29).
ACM_HEADER_LEN = 14
#: Extra bytes the WAVC wrapper prepends (util.c:28).
WAVC_HEADER_LEN = 28


class AcmError(enum.IntEnum):
    """Error codes, numerically identical to the reference (libacm.h:31-39)."""

    OK = 0
    ERR_OTHER = -1
    ERR_OPEN = -2
    ERR_NOT_ACM = -3
    ERR_READ_ERR = -4
    ERR_BADFMT = -5
    ERR_CORRUPT = -6
    ERR_UNEXPECTED_EOF = -7
    ERR_NOT_SEEKABLE = -8


#: Internal sentinel: EOF at a block header / column-code boundary is a clean
#: end-of-stream, not an error (decode.c:31, 154-163, 588-589, 496).
ACM_EXPECTED_EOF = -99

_ERRLIST = (
    "No error",
    "ACM error",
    "Cannot open file",
    "Not an ACM file",
    "Read error",
    "Bad format",
    "Corrupt file",
    "Unexcpected EOF",  # [sic] — string kept identical to util.c:42
    "Stream not seekable",
)


def acm_strerror(err: int) -> str:
    """Error-code → message, identical strings/fallback to util.c:46-52."""
    idx = -int(err)
    if idx < 0 or idx >= len(_ERRLIST):
        return "Unknown error"
    return _ERRLIST[idx]


class AcmException(Exception):
    """Exception carrying a reference-compatible error code."""

    def __init__(self, code: int, detail: str = ""):
        self.code = int(code)
        msg = acm_strerror(code)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


@dataclasses.dataclass
class ACMInfo:
    """Mirror of the reference's `ACMInfo` (libacm.h:41-50).

    ``channels`` is the *effective* channel count after force_chans logic;
    ``acm_channels`` is the raw header value (often wrong in the wild).
    """

    channels: int = 0
    rate: int = 0
    acm_id: int = 0
    acm_version: int = 0
    acm_channels: int = 0
    acm_level: int = 0
    acm_cols: int = 0  # 1 << acm_level
    acm_rows: int = 0


@dataclasses.dataclass(frozen=True)
class AcmHeader:
    """Parsed stream header + derived geometry (decode.c:712-752, 802-804)."""

    total_values: int  # interleaved sample words in the stream
    channels: int  # raw header channels (1..2 accepted)
    rate: int
    level: int  # 4-bit; cols = 1 << level
    rows: int  # 12-bit, != 0
    wavc_file: bool = False

    @property
    def cols(self) -> int:
        return 1 << self.level

    @property
    def block_len(self) -> int:
        """Words per block (decode.c:804)."""
        return self.rows * self.cols

    @property
    def wrapbuf_len(self) -> int:
        """Inter-block filterbank carry length (decode.c:803)."""
        return 2 * self.cols - 2

    @property
    def data_start(self) -> int:
        """Byte offset where the bitstream begins (util.c:223-226)."""
        return ACM_HEADER_LEN + (WAVC_HEADER_LEN if self.wavc_file else 0)

    @property
    def n_blocks(self) -> int:
        """Number of blocks a conforming reader will ever decode.

        acm_read stops once stream_pos reaches total_values (decode.c:837),
        so at most ceil(total_values / block_len) blocks are touched.
        """
        return -(-self.total_values // self.block_len)

    def max_blocks_in(self, nbytes: int) -> int:
        """Physical block capacity of an nbytes-long stream.

        `total_values` is attacker-controlled (a corrupt header can claim
        2^32 samples); a successful block costs at least 4+16 header bits
        plus a 5-bit code per column, so the stream length bounds how many
        blocks can actually decode — allocate for that, not the claim.
        """
        cap = (8 * (nbytes + 1)) // (20 + 5 * self.cols) + 1
        return max(1, min(self.n_blocks, cap))


def cli_total_bytes(total_values: int, channels: int, *,
                    signed: bool = True) -> int:
    """The reference CLI's `total_bytes = acm_pcm_total * channels * 2`
    in C integer arithmetic (acmtool.c:272 decode path, acmtool.c:113 play
    path). `acm_pcm_total` is unsigned `total_values / channels`
    (util.c:177-180); the product wraps at 2^32. decode_file stores it in a
    signed `int` — a corrupt header claiming ~2^30+ samples makes it
    negative and acmtool -d emits nothing past the WAV header; play_file
    stores it in an `unsigned int`, so the same header wraps to a small
    positive count instead. Reproduced for bit-exact CLI parity."""
    tb = ((total_values // channels) * channels * ACM_WORD) & 0xFFFFFFFF
    if signed and tb >= (1 << 31):
        tb -= 1 << 32
    return tb


def sniff_bytes(data: bytes) -> tuple[bool, bool]:
    """Content sniff of the leading bytes: `(is_plain_acm, is_wavc)`.

    The typefind analog — the reference's players register both forms by
    magic (gstreamer matches the 3-byte magic 97 28 03,
    plugin-gstreamer.c:159-170; xmms2 registers the full LE dword
    0x01032897 = magic+version AND the 'WAVC' wrapper,
    plugin-xmms2.c:239-247). Plain ACM: magic 0x032897 with, when
    present, version byte 1 (decode.c:727-733 rejects other versions).
    WAVC: 'WAVC' then 'V1.0' — the only wrapper words the decoder
    actually checks (decode.c:718-728).
    """
    acm = (len(data) >= 3 and data[:3] == b"\x97\x28\x03"
           and (len(data) < 4 or data[3] == 1))
    wavc = len(data) >= 8 and data[:8] == b"WAVCV1.0"
    return acm, wavc


def is_acm(data: bytes) -> bool:
    """True when `data` begins a decodable stream (plain ACM or WAVC)."""
    acm, wavc = sniff_bytes(data)
    return acm or wavc


def sniff(path) -> tuple[bool, bool]:
    """`(is_plain_acm, is_wavc)` from the first bytes of the file at `path`."""
    with open(path, "rb") as fh:
        return sniff_bytes(fh.read(8))


def resolve_channels(header_channels: int, wavc_file: bool, force_chans: int) -> int:
    """force_chans resolution, identical to decode.c:786-799.

    >0: override; 0: trust header; -1: quirk mode — plain ACM files are
    assumed stereo (mis-tagged mono files are common in the wild) while WAVC
    headers are trusted.
    """
    if force_chans > 0:
        return force_chans
    if force_chans == -1 and not wavc_file and header_channels < 2:
        return 2
    return header_channels
