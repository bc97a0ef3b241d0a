"""ctypes loader/wrapper for the C++ scanner (`_scan.cpp`, built inside
`_crops.cpp`, which adds the port's random-access entry).

Compiles the shared object on demand with g++ (no Python headers needed —
the ABI is plain C arrays) into a content-hash-keyed cache next to this
package, and exposes `scan_bytes` with semantics identical to
`oracle.scan_bytes` (differential-fuzzed in tests/test_scan_native.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import subprocess
import sys
import tempfile
import threading

import numpy as np

from ..format import ACM_HEADER_LEN, WAVC_HEADER_LEN, AcmHeader
from . import oracle
from .oracle import BitReader, ScanResult, parse_header

_HERE = pathlib.Path(__file__).resolve().parent
#: the scanner shared with the JAX package (byte-identical to its copy)
_SRC = _HERE / "_scan.cpp"
#: the translation unit built: _SRC, included, and the port's own entries
_UNIT = _HERE / "_crops.cpp"

_lib = None
_tried = False


def _build() -> pathlib.Path | None:
    """Compile the scanner, profile-guided when possible.

    PGO pipeline (best-effort; any failure falls back to the plain -O3
    build): instrumented object → training run over representative
    synthesized streams (all three entry-point template instantiations) →
    -fprofile-use rebuild. Interleaved A/B on this host: ~10% faster on
    dense (music-style) content, ~4% on mid-level geometries, neutral on
    sparse speech. -fprofile-partial-training keeps static heuristics for
    any code path the trainer missed (instead of treating it as cold).
    """
    try:
        src = _SRC.read_bytes() + _UNIT.read_bytes()
    except OSError:
        return None  # a source missing from the install: no native path
    tag = hashlib.sha256(src + b"|pgo2").hexdigest()[:16]
    cache_dir = pathlib.Path(
        os.environ.get("LIBACM_TPU_TORCH_CACHE", _HERE / "_build")
    )
    so = cache_dir / f"_scan-{tag}.so"
    if so.exists():
        return so
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(
            suffix=".so", dir=cache_dir, delete=False
        ) as tmp:
            tmp_path = pathlib.Path(tmp.name)
        # -mprefer-vector-width=512: gcc defaults to 256-bit vectors even
        # with AVX-512 available; the fused host synth (pure uint32 FIR
        # sweeps) runs ~20% faster at 512 and the serial scan is unharmed
        # (interleaved A/B on the mixed bench corpus, tools/scanbench).
        # Ice-Lake-class cores don't downclock for 512-bit integer ops.
        cc = ["g++", "-O3", "-march=native", "-mprefer-vector-width=512",
              "-std=c++17", "-fPIC"]
        plain = cc + ["-shared", "-o", str(tmp_path), str(_UNIT)]
        try:
            subprocess.run(plain, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            # portability fallback (non-x86 or older gcc)
            cc.remove("-march=native")
            cc.remove("-mprefer-vector-width=512")
            plain = cc + ["-shared", "-o", str(tmp_path), str(_UNIT)]
            subprocess.run(plain, check=True, capture_output=True)
        try:
            with tempfile.TemporaryDirectory(dir=cache_dir) as work:
                obj = str(pathlib.Path(work) / "scan_prof.o")
                prof_so = str(pathlib.Path(work) / "scan_prof.so")
                subprocess.run(
                    cc + ["-fprofile-generate", "-c", str(_UNIT), "-o",
                          obj],
                    check=True, capture_output=True)
                subprocess.run(
                    ["g++", "-shared", "-fprofile-generate", "-o", prof_so,
                     obj],
                    check=True, capture_output=True)
                if _pgo_train(prof_so, tag,
                              pathlib.Path(work) / "scan_prof.gcda"):
                    # same -o so -fprofile-use finds scan_prof.gcda
                    subprocess.run(
                        cc + ["-fprofile-use", "-fprofile-correction",
                              "-fprofile-partial-training",
                              "-c", str(_UNIT), "-o", obj],
                        check=True, capture_output=True)
                    subprocess.run(
                        ["g++", "-shared", "-o", str(tmp_path), obj],
                        check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            pass  # keep the plain build
        tmp_path.replace(so)  # atomic under concurrent builders
        return so
    except (OSError, subprocess.CalledProcessError):
        return None


_PGO_TRAIN_SCRIPT = """
import numpy as np
from libacm_tpu_torch.scan import native as N
from libacm_tpu_torch import testing as T
rng = np.random.default_rng(0)
# sparse 22 kHz speech, dense 44.1 kHz stereo music, mid/low geometries
# -- the content classes the real corpora hit; decode_host +
# scan_bytes_packed + scan_bytes cover all three emitter instantiations
streams = [
    T.speech_acm_bytes(rng, level=7, rows=16, n_blocks=30),
    T.speech_acm_bytes(rng, level=7, rows=16, n_blocks=30, channels=2,
                       base_pwr=8, decay_cols=24.0),
    T.speech_acm_bytes(rng, level=4, rows=40, n_blocks=80),
    T.speech_acm_bytes(rng, level=0, rows=512, n_blocks=20),
]
assert N.available()
for d in streams:
    for _ in range(4):
        N.decode_host(d)
        N.scan_bytes_packed(d)
        N.scan_bytes(d)
"""


def _pgo_train(prof_so: str, tag: str, gcda: pathlib.Path) -> bool:
    """Run the training workload in a SUBPROCESS against the instrumented
    library, staged as the expected cache entry of a private cache dir:
    this process's module globals never point at the instrumented lib
    (concurrent _load callers are unaffected), and the gcov counters
    flush on normal child exit — no dlclose of a possibly-shared handle.
    The .gcda path is baked into the object at compile time, so the child
    writes it into our tempdir. Returns True once counters exist."""
    import shutil
    import sys

    cache = pathlib.Path(prof_so).parent / "traincache"
    cache.mkdir()
    shutil.copy2(prof_so, cache / f"_scan-{tag}.so")
    env = dict(
        os.environ,
        LIBACM_TPU_TORCH_CACHE=str(cache),
        PYTHONPATH=os.pathsep.join(
            [str(_HERE.parents[1])]
            + ([os.environ["PYTHONPATH"]] if "PYTHONPATH" in os.environ
               else [])),
    )
    try:
        r = subprocess.run([sys.executable, "-c", _PGO_TRAIN_SCRIPT],
                           env=env, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0 and gcda.exists()


_LOAD_LOCK = threading.Lock()


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    # double-checked: concurrent first native touches (decode_corpus_host
    # workers) must not see _tried=True while another thread is still in
    # the seconds-long _build()/dlopen, nor build twice
    with _LOAD_LOCK:
        if _tried:
            return _lib
        so = _build()
        if so is not None:
            _lib = _bind(ctypes.CDLL(str(so)))
        _tried = True
    return _lib


def _bind(lib):
    """Attach the ctypes signatures to a loaded scanner library."""
    fn = lib.acm_scan_blocks
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,  # data, nbytes
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,  # skip, level, rows
        ctypes.c_int64, ctypes.c_int64,  # max_blocks, max_events
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int64),
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fc = lib.acm_scan_corpus_into
    fc.restype = ctypes.c_int64
    fc.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64,
        u8p,  # cls slot
        u8p, u8p, u8p,  # pay4/8/16 bit streams
        u8p, u8p, u8p,  # wid4/8/16 width-nibble streams
        u8p, ctypes.POINTER(ctypes.c_uint16),  # pwr, val
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,  # final_data
    ]
    fk = lib.acm_scan_corpus_chunk
    fk.restype = ctypes.c_int64
    fk.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,  # ...max_blocks, n
        ctypes.c_int32, ctypes.c_int32,  # level, rows
        ctypes.c_int64, ctypes.c_int64,  # nb_stride, cls_stride
        u8p,  # cls
        u8p, u8p, u8p,  # pay4/8/16 bit streams
        u8p, u8p, u8p,  # wid4/8/16 width-nibble streams
        u8p, ctypes.POINTER(ctypes.c_uint16),  # pwr, val
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64,  # max_events, ev_cap
        ctypes.POINTER(ctypes.c_int16),  # events_out
        ctypes.POINTER(ctypes.c_int16),  # col_tmp
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    fr = lib.acm_scan_crops
    fr.restype = ctypes.c_int64
    fr.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,  # clip rows, starts (int64 each)
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # n, frames, pad
        ctypes.c_void_p, ctypes.c_int64,  # blob, its capacity
        ctypes.c_void_p,  # out
    ]
    fh = lib.acm_decode_host
    fh.restype = ctypes.c_int64
    fh.argtypes = [
        # data as a raw uint8 pointer (not c_char_p): the windowed stream
        # passes its live bytearray zero-copy — a per-fill bytes() copy of
        # the O(64 KiB) window would dominate small-block fills
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,  # max_blocks, max_events
        ctypes.POINTER(ctypes.c_int16),  # pcm_out
        ctypes.POINTER(ctypes.c_uint32),  # wrap
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int16),  # col_tmp
        ctypes.POINTER(ctypes.c_int16),  # kbuf
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,  # final_data
        ctypes.POINTER(ctypes.c_uint32),  # tbl_val [17] (nullable)
        ctypes.POINTER(ctypes.c_int64),  # tbl_cov [17] (nullable)
        ctypes.POINTER(ctypes.c_uint8),  # ev_pwr [max_events] (nullable)
        ctypes.POINTER(ctypes.c_uint16),  # ev_val [max_events] (nullable)
    ]
    fb = lib.acm_decode_corpus_host_batch
    fb.restype = ctypes.c_int64
    fb.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,  # n_files
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,  # max_events
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64),  # out
    ]
    fs = lib.acm_synth_dense
    fs.restype = ctypes.c_int64
    fs.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int16),
    ]
    fp = lib.acm_scan_blocks_packed
    fp.restype = ctypes.c_int64
    fp.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
        u8p,  # cls
        u8p, u8p, u8p,  # pay4/8/16 bit streams
        u8p, u8p, u8p,  # wid4/8/16 width-nibble streams
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _raw_ptr(a: np.ndarray, ctype):
    """Pointer to `a`'s data with NO back-reference to the array.

    `ndarray.ctypes.data_as` stores the array on the returned pointer and
    ctypes objects sit in reference cycles, so the array — and with it
    the PEP-3118 buffer EXPORT of whatever `a` views — survives until a
    gc pass. For buffer-protocol inputs the caller RESIZES between calls
    (the windowed decoders' bytearrays), that delayed release turns
    `buf += chunk` into BufferError (fuzz seed 6100 round 1524). The
    caller must keep `a` alive across the native call."""
    return ctypes.cast(ctypes.c_void_p(a.ctypes.data),
                       ctypes.POINTER(ctype))


def _prep(data: bytes, max_blocks: int | None,
          header: "AcmHeader | None" = None):
    lib = _load()
    if lib is None:
        raise RuntimeError("native scanner not available")
    if header is None:
        header = parse_header(BitReader(data))
    if header is None:
        raise ValueError("not an ACM stream")
    if max_blocks is None:
        max_blocks = header.n_blocks
    # a corrupt header can claim 2^32 samples; allocate for what the
    # stream's byte length can physically contain (+2 attempts so the
    # scanner still discovers EOF and reports the right terminal status)
    byte_cap = (8 * (len(data) + 1)) // (20 + 5 * header.cols) + 2
    max_blocks = min(max_blocks, byte_cap)
    skip_bits = 8 * (ACM_HEADER_LEN + (WAVC_HEADER_LEN if header.wavc_file else 0))
    # every recorded event consumes >= 20 payload bits (pwr+val), so this
    # bound cannot be hit; +4 covers reservoir-tail attempts
    max_events = (8 * (len(data) + 1)) // 20 + 4
    return lib, header, max_blocks, skip_bits, max_events


def scan_bytes(data: bytes, max_blocks: int | None = None) -> ScanResult:
    """Header parse (Python) + native block scan. Same result as the oracle."""
    lib, header, max_blocks, skip_bits, max_events = _prep(data, max_blocks)
    rows, cols = header.rows, header.cols

    k = np.zeros((max_blocks, rows, cols), dtype=np.int16)
    pwr = np.zeros(max_blocks, dtype=np.uint8)
    val = np.zeros(max_blocks, dtype=np.uint16)
    events = np.zeros(max_events, dtype=np.int16)
    tell = np.zeros(max_events, dtype=np.int64)
    col_tmp = np.zeros(rows, dtype=np.int16)
    meta = np.zeros(16, dtype=np.int64)

    rc = lib.acm_scan_blocks(
        data, len(data), skip_bits, header.level, rows,
        max_blocks, max_events,
        _ptr(k, ctypes.c_int16), _ptr(pwr, ctypes.c_uint8),
        _ptr(val, ctypes.c_uint16), _ptr(events, ctypes.c_int16),
        _ptr(tell, ctypes.c_int64), _ptr(col_tmp, ctypes.c_int16),
        _ptr(meta, ctypes.c_int64),
    )
    if rc != 0 or meta[9]:
        # rc!=0 cannot happen per the bound above; meta[9] = the stream has
        # out-of-range coefficient indexes (stale-amp-table semantics) —
        # the oracle reproduces the reference's stale values exactly
        return oracle.scan_bytes(bytes(data), max_blocks)

    n_blocks, n_events, status, tell_end, tell0 = (int(x) for x in meta[:5])
    return ScanResult(
        header=header,
        k=k[:n_blocks],
        pwr=pwr[:n_blocks],
        val=val[:n_blocks],
        n_blocks=n_blocks,
        events=events[:n_events].copy(),
        status=status,
        raw_tell=tell[:n_events].copy(),
        raw_tell0=tell0,
        raw_tell_end=tell_end,
    )


@dataclasses.dataclass
class PackedScan:
    """Wire-format (v2, exact-width) scan output.

    Class codes per (block, column): 0 all-zero, 1 width <= 4, 2 width
    5..8, 3 width 9..16 — the family is a static property of the filler
    code. Each family has a flat LSB-first BIT stream (`pay*`) where a
    nonzero column occupies rows*w bits (two's-complement values at the
    filler's wire width w), plus a width-nibble stream (`wid*`, w-1 per
    column, two per byte). Columns appear in (block, column) scan order.
    """

    header: AcmHeader
    n_blocks: int
    cls: np.ndarray  # uint8 [n_blocks, cols] (unpacked codes)
    pay4: np.ndarray  # uint8 bit stream (class-1 columns)
    pay8: np.ndarray  # uint8 bit stream (class-2 columns)
    pay16: np.ndarray  # uint8 bit stream (class-3 columns)
    wid4: np.ndarray  # uint8 width nibbles
    wid8: np.ndarray
    wid16: np.ndarray
    pwr: np.ndarray  # uint8 [n_blocks]
    val: np.ndarray  # uint16 [n_blocks]
    events: np.ndarray
    status: int
    #: columns per class and used bits per stream
    n_cols: tuple[int, int, int] = (0, 0, 0)
    bits: tuple[int, int, int] = (0, 0, 0)
    #: stream contains out-of-range coefficient indexes (stale-amp-table
    #: semantics apply; synthesis from k*val alone is NOT bit-exact)
    oor: bool = False

    @property
    def wire_bytes(self) -> int:
        # cls ships 2-bit packed on the real wire
        return (-(-self.cls.size // 4) + self.pay4.nbytes + self.pay8.nbytes
                + self.pay16.nbytes + self.wid4.nbytes + self.wid8.nbytes
                + self.wid16.nbytes + self.val.nbytes)


#: Writable tail slack (bytes) every payload BIT stream needs: the
#: scanner's bulk writes OR up to 9 bytes at once past the current
#: column, and the device unpack gathers 16-bit windows that may touch 2
#: bytes past the last used bit.
PAY_SLACK = 16


def _even(n: int) -> int:
    return n + (n & 1)


def pay_stream_caps(ncols_cap: int, rows: int) -> tuple[int, int, int, int]:
    """(pay4, pay8, pay16, wid) byte capacities for ncols_cap columns.

    All even: the device unpack views the streams as uint16 pairs."""
    def cap(bits: int) -> int:
        n = -(-bits // 8) + PAY_SLACK
        return n + (n & 1)

    return (cap(ncols_cap * rows * 4), cap(ncols_cap * rows * 8),
            cap(ncols_cap * rows * 16), -(-ncols_cap // 2) + 8)


def unpack_cls(packed: np.ndarray, cols: int) -> np.ndarray:
    """2-bit-packed class map [..., ceil(cols/4)] → uint8 codes [..., cols]."""
    shifts = np.arange(4, dtype=np.uint8) * 2
    codes = (packed[..., :, None] >> shifts) & 3
    return codes.reshape(packed.shape[:-1] + (4 * packed.shape[-1],))[..., :cols]


class CorpusScanBuffers:
    """Reusable scratch for scan_corpus_into (events/tell/col/meta)."""

    def __init__(self, max_rows: int = 4096, max_file_bytes: int = 1 << 22):
        self.events = np.zeros((8 * (max_file_bytes + 1)) // 20 + 4,
                               dtype=np.int16)
        self.tell = np.zeros_like(self.events, dtype=np.int64)
        self.col = np.zeros(max_rows, dtype=np.int16)
        self.meta = np.zeros(16, dtype=np.int64)

    def fits(self, nbytes: int) -> bool:
        return (8 * (nbytes + 1)) // 20 + 4 <= len(self.events)


_BUFS_TLS = threading.local()


def scan_buffers(nbytes: int) -> CorpusScanBuffers:
    """This thread's CorpusScanBuffers, made anew where they cannot hold
    a scan of nbytes bytes (at least 4 MiB of file)."""
    bufs = getattr(_BUFS_TLS, "bufs", None)
    if bufs is None or not bufs.fits(nbytes):
        bufs = _BUFS_TLS.bufs = CorpusScanBuffers(
            max_file_bytes=max(1 << 22, nbytes))
    return bufs


def scan_corpus_into(
    data: bytes,
    header: AcmHeader,
    cls_slot: np.ndarray,  # uint8 [nb, ceil(cols/4)] — this file's slot
    pwr_slot: np.ndarray,  # uint8 [nb]
    val_slot: np.ndarray,  # uint16 [nb]
    pay4: np.ndarray, pay8: np.ndarray, pay16: np.ndarray,  # uint8 streams
    wid4: np.ndarray, wid8: np.ndarray, wid16: np.ndarray,  # uint8 nibbles
    bufs: CorpusScanBuffers,
    start_bit: int | None = None,
    bitpos_out: np.ndarray | None = None,  # int64 [nb]: per-block bit offset
    final: bool = True,
    max_blocks: int | None = None,
) -> tuple[int, int, tuple[int, int, int], tuple[int, int, int], bool,
           np.ndarray]:
    """Zero-copy corpus scan of one file into v2 wire buffers.

    Returns (n_good_blocks, first_err, n_cols (per class), bits (per
    class stream), oor, events). `oor` signals out-of-range coefficient
    indexes (stale-amp-table semantics; callers must fall back to the
    oracle for exactness). `events` is the per-attempt outcome array
    (0 = good block, negative = error): the C scan runs with
    stop_on_error=false, deliberately continuing past failed decode
    attempts so cli_stop_words can model the reference CLI's
    error-swallowing read loop; `n_good_blocks` counts only committed
    blocks. `start_bit` overrides the default header-skip start (random
    access via a BlockIndex entry); `bitpos_out` collects the index on a
    full scan. `final=False` scans `data` as a partial stream window
    (NEED_MORE_DATA semantics; resume at `bufs.meta[10]`) — the windowed
    wire producer for decode_stream_device. `data` may be any
    buffer-protocol object when windowed.
    """
    lib = _load()
    assert lib is not None and bufs.fits(len(data))
    if start_bit is None:
        start_bit = 8 * (
            ACM_HEADER_LEN + (WAVC_HEADER_LEN if header.wavc_file else 0)
        )
    if max_blocks is None:
        max_blocks = header.n_blocks
    max_blocks = min(max_blocks, cls_slot.shape[0])
    # _raw_ptr, not _ptr: `data` is often a view of a bytearray the
    # caller grows between windows — the export must release at return
    dview = np.frombuffer(data, dtype=np.uint8)
    rc = lib.acm_scan_corpus_into(
        ctypes.cast(_raw_ptr(dview, ctypes.c_uint8), ctypes.c_char_p),
        len(dview), start_bit, header.level, header.rows, max_blocks,
        _ptr(cls_slot, ctypes.c_uint8),
        _ptr(pay4, ctypes.c_uint8), _ptr(pay8, ctypes.c_uint8),
        _ptr(pay16, ctypes.c_uint8),
        _ptr(wid4, ctypes.c_uint8), _ptr(wid8, ctypes.c_uint8),
        _ptr(wid16, ctypes.c_uint8),
        _ptr(pwr_slot, ctypes.c_uint8), _ptr(val_slot, ctypes.c_uint16),
        _ptr(bufs.events, ctypes.c_int16), _ptr(bufs.tell, ctypes.c_int64),
        len(bufs.events), _ptr(bufs.col, ctypes.c_int16),
        _ptr(bufs.meta, ctypes.c_int64),
        _ptr(bitpos_out, ctypes.c_int64) if bitpos_out is not None else None,
        1 if final else 0,
    )
    if rc != 0:
        raise RuntimeError("corpus scan: event capacity exceeded")
    m = bufs.meta
    return (int(m[0]), int(m[8]),
            (int(m[5]), int(m[6]), int(m[7])),
            (int(m[12]), int(m[13]), int(m[14])),
            bool(m[9]), bufs.events[: int(m[1])].copy())


def scan_corpus_chunk(
    blob: np.ndarray,  # uint8, files back to back
    offs: np.ndarray, lens: np.ndarray,  # int64 [n]
    skips: np.ndarray, maxbs: np.ndarray,  # int64 [n]
    level: int, rows: int,
    cls: np.ndarray,  # uint8 [n, nb, ceil(cols/4)]
    pwr: np.ndarray, vals: np.ndarray,  # [n, nb]
    pay4: np.ndarray, pay8: np.ndarray, pay16: np.ndarray,  # uint8 streams
    wid4: np.ndarray, wid8: np.ndarray, wid16: np.ndarray,  # uint8 nibbles
    bufs: CorpusScanBuffers,
    ev_cap: int,
) -> tuple[np.ndarray, np.ndarray, tuple[int, int, int],
           tuple[int, int, int]]:
    """Batched packed scan of one bucket chunk in a single native call.

    Returns (out int64 [n, 5] = n_good/first_err/oor/n_events/overflow,
    events int16 [n, ev_cap], n_cols per class, bits per class stream).
    A file flagged `overflow` produced more events than ev_cap (heavily
    corrupt) — the caller must rescan it solo for the full event list.
    Replaces n per-file ctypes round trips with one GIL-released sweep
    over the whole chunk.
    """
    lib = _load()
    n = len(offs)
    assert lib is not None and (n == 0 or bufs.fits(int(lens.max())))
    out = np.zeros((n, 5), dtype=np.int64)
    events = np.empty((n, max(ev_cap, 1)), dtype=np.int16)
    rc = lib.acm_scan_corpus_chunk(
        _ptr(blob, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), _ptr(skips, ctypes.c_int64),
        _ptr(maxbs, ctypes.c_int64), n, level, rows,
        pwr.shape[1] if pwr.ndim > 1 else len(pwr), cls[0].nbytes if n else 0,
        _ptr(cls, ctypes.c_uint8),
        _ptr(pay4, ctypes.c_uint8), _ptr(pay8, ctypes.c_uint8),
        _ptr(pay16, ctypes.c_uint8),
        _ptr(wid4, ctypes.c_uint8), _ptr(wid8, ctypes.c_uint8),
        _ptr(wid16, ctypes.c_uint8),
        _ptr(pwr, ctypes.c_uint8), _ptr(vals, ctypes.c_uint16),
        _ptr(bufs.events, ctypes.c_int16), _ptr(bufs.tell, ctypes.c_int64),
        len(bufs.events), ev_cap,
        _ptr(events, ctypes.c_int16), _ptr(bufs.col, ctypes.c_int16),
        _ptr(bufs.meta, ctypes.c_int64), _ptr(out, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"chunk scan: event capacity exceeded (file {-rc - 1})")
    m = bufs.meta
    return (out, events, (int(m[5]), int(m[6]), int(m[7])),
            (int(m[12]), int(m[13]), int(m[14])))


#: scan_crops's result: a head, a row a geometry, a row a crop (int64)
CROP_HEAD, CROP_GEOM, CROP_INFO = 8, 16, 8
#: a crop's code in its result row
CROP_DEVICE, CROP_HOST, CROP_STALE, CROP_PAST, CROP_PAD = range(5)
#: scan_crops's status
CROPS_DONE, CROPS_PAD_REFUSED, CROPS_STALE, CROPS_BLOB_SMALL = range(4)


def clip_row(data, bitpos: np.ndarray, header: AcmHeader, n_good: int,
             channels: int, oor: bool) -> tuple[bytes, tuple]:
    """A clip's row of scan_crops's table, and the arrays that must stay
    alive while a call reads it. The row is ten int64 (CLIP_* in
    _crops.cpp): the address and length of the clip's bytes, the address of
    its int64 block bits, n_good, total_values, level, rows, data_start,
    channels and oor."""
    d = np.frombuffer(data, dtype=np.uint8)
    bp = np.ascontiguousarray(bitpos, dtype=np.int64)
    row = np.array([d.ctypes.data, len(d), bp.ctypes.data, n_good,
                    header.total_values, header.level, header.rows,
                    header.data_start, channels, int(oor)], dtype=np.int64)
    return row.tobytes(), (d, bp)


def scan_crops(clips: bytes, starts: bytes, n: int, frames: int, pad: bool,
               blob: int, cap: int, out: int) -> int:
    """One GIL-free call that plans n crops, scans their spans in place and
    lays their wire and metadata out in the blob at address `blob`
    (`cap` bytes); `clips` holds n rows of clip_row, `starts` n int64
    first frames, `out` the address of an int64 array of at least
    CROP_HEAD + (CROP_GEOM + CROP_INFO) * n. A null blob (blob=0, cap=0)
    asks for the plan alone: the CROP_INFO rows, with nothing scanned or
    laid out, and CROPS_DONE or CROPS_PAD_REFUSED. Returns a CROPS_*
    status; the plan, the layout and the tables are documented at
    acm_scan_crops in _crops.cpp.
    """
    return _load().acm_scan_crops(clips, starts, n, frames, 1 if pad else 0,
                                  blob, cap, out)


#: Per-thread scratch for scan_bytes_packed: the PackedEmitter tolerates
#: stale buffer content by design (begin_block memsets its cls row; width
#: nibbles overwrite whole bytes on even columns; BitStreamSink masks the
#: partial start byte and flushes zero high bits), and every array the
#: caller sees is a copy/slice whose undefined slack is re-zeroed below —
#: so reuse is safe and saves the dominant cost of the one-shot API
#: (np.zeros of generously-capped streams per file: measured ~2.4x wall
#: on the bench corpus). Buffers above _SCRATCH_CAP bytes are not pooled.
_PACKED_TLS = threading.local()
_SCRATCH_CAP = 256 << 20


def _pool_scratch(name: str, n: int, dtype) -> np.ndarray:
    pool = getattr(_PACKED_TLS, "pool", None)
    if pool is None:
        pool = _PACKED_TLS.pool = {}
    a = pool.get(name)
    if a is not None and a.size >= n:
        return a[:n]
    # _SCRATCH_CAP bounds the POOL, not the allocation: one oversized file
    # (or many threads) must not pin hundreds of MB of dead scratch for
    # the process lifetime — beyond the budget, allocate fresh/unpooled.
    grown = max(n, 2 * (a.size if a is not None else 0))
    held = sum(v.nbytes for k, v in pool.items() if k != name)
    if held + grown * np.dtype(dtype).itemsize > _SCRATCH_CAP:
        return np.empty(n, dtype=dtype)
    a = pool[name] = np.empty(grown, dtype=dtype)
    return a[:n]


def scan_bytes_packed(data: bytes, max_blocks: int | None = None) -> PackedScan:
    """Native scan straight into the corpus wire format (see PackedScan)."""
    lib, header, max_blocks, skip_bits, max_events = _prep(data, max_blocks)
    rows, cols = header.rows, header.cols
    ncols_cap = max_blocks * cols
    c4, c8, c16, cw = pay_stream_caps(ncols_cap, rows)

    stride = (cols + 3) // 4
    cls = _pool_scratch("cls", max_blocks * stride, np.uint8).reshape(
        max_blocks, stride)
    pay4 = _pool_scratch("pay4", c4, np.uint8)
    pay8 = _pool_scratch("pay8", c8, np.uint8)
    pay16 = _pool_scratch("pay16", c16, np.uint8)
    wid4 = _pool_scratch("wid4", cw, np.uint8)
    wid8 = _pool_scratch("wid8", cw, np.uint8)
    wid16 = _pool_scratch("wid16", cw, np.uint8)
    pwr = _pool_scratch("pwr", max_blocks, np.uint8)
    val = _pool_scratch("val", max_blocks, np.uint16)
    events = _pool_scratch("events", max_events, np.int16)
    tell = _pool_scratch("tell", max_events, np.int64)
    col_tmp = np.zeros(rows, dtype=np.int16)
    meta = np.zeros(16, dtype=np.int64)

    rc = lib.acm_scan_blocks_packed(
        data, len(data), skip_bits, header.level, rows,
        max_blocks, max_events,
        _ptr(cls, ctypes.c_uint8),
        _ptr(pay4, ctypes.c_uint8), _ptr(pay8, ctypes.c_uint8),
        _ptr(pay16, ctypes.c_uint8),
        _ptr(wid4, ctypes.c_uint8), _ptr(wid8, ctypes.c_uint8),
        _ptr(wid16, ctypes.c_uint8),
        _ptr(pwr, ctypes.c_uint8), _ptr(val, ctypes.c_uint16),
        _ptr(events, ctypes.c_int16), _ptr(tell, ctypes.c_int64),
        _ptr(col_tmp, ctypes.c_int16), _ptr(meta, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError("packed scan: event capacity exceeded")

    n_blocks = int(meta[0])
    ncol = (int(meta[5]), int(meta[6]), int(meta[7]))
    bits = (int(meta[12]), int(meta[13]), int(meta[14]))

    def pay_copy(a: np.ndarray, nbits: int) -> np.ndarray:
        # bytes past ceil(nbits/8) in the even-rounded +2 slack were never
        # written this call (pooled scratch) — zero them so the wire bytes
        # stay deterministic (byte-equality tests, relay dedup)
        nwr = -(-nbits // 8)
        out = a[: _even(nwr + 2)].copy()
        out[nwr:] = 0
        return out

    return PackedScan(
        header=header,
        n_blocks=n_blocks,
        cls=unpack_cls(cls[:n_blocks], cols),
        pay4=pay_copy(pay4, bits[0]),
        pay8=pay_copy(pay8, bits[1]),
        pay16=pay_copy(pay16, bits[2]),
        wid4=wid4[: -(-ncol[0] // 2)].copy(),
        wid8=wid8[: -(-ncol[1] // 2)].copy(),
        wid16=wid16[: -(-ncol[2] // 2)].copy(),
        pwr=pwr[:n_blocks].copy(),  # pooled scratch: views must not escape
        val=val[:n_blocks].copy(),
        events=events[: int(meta[1])].copy(),
        status=int(meta[2]),
        n_cols=ncol,
        bits=bits,
        oor=bool(meta[9]),
    )


#: Windowed scan only: the buffer ran dry mid-attempt (attempt rolled
#: back; retry from `end_bit` once more bytes arrive).
NEED_MORE_DATA = -98


@dataclasses.dataclass
class HostDecode:
    """Output of the fused host scan+synth path (`acm_decode_host`)."""

    header: AcmHeader
    #: int16 PCM words of the committed blocks, [n_good * block_len]
    pcm: np.ndarray
    n_good: int
    first_err: int  # first error event, 0 if clean
    events: np.ndarray
    #: terminal scan status (0 / ACM_EXPECTED_EOF / NEED_MORE_DATA)
    status: int
    #: stream has out-of-range coefficient indexes. Informational only:
    #: the PCM is still bit-exact — the emitter reproduces the reference's
    #: stale-amp-table reads via a virtual table (same trick as the oracle)
    oor: bool
    #: absolute consumed-bit position after the last attempt (resume point
    #: for the next window) and the filterbank carry at that point
    end_bit: int
    wrap: np.ndarray  # uint32 [2*cols-2]
    #: per-event consumed-bit positions (windowed raw_tell reconstruction)
    ev_bits: np.ndarray | None = None
    #: per-event amp-table header fields (seek-path table reconstruction:
    #: the reference's persistent table must reflect only the attempts its
    #: reads consumed, not a window's decode-ahead)
    ev_pwr: np.ndarray | None = None
    ev_val: np.ndarray | None = None
    #: the TERMINAL attempt's (pwr, val), when it read them before hitting
    #: clean EOF at a column code — no event exists, but the reference's
    #: amp table was updated by it (decode.c:591-599 runs before
    #: fill_block); None when the stream ended at the header reads
    term_att: tuple[int, int] | None = None


def _aligned_zeros(n: int, dtype, align: int = 64) -> np.ndarray:
    """Zeroed array whose data pointer is `align`-byte aligned (the native
    synth engages its AVX-512 pass bodies only on 64-byte-aligned
    scratch; numpy's allocator guarantees 16)."""
    item = np.dtype(dtype).itemsize
    raw = np.zeros(n + align // item, dtype=dtype)
    off = (-raw.ctypes.data % align) // item
    return raw[off : off + n]


class HostDecodeScratch:
    """Reusable per-(level, rows) scratch for decode_host/synth_dense."""

    def __init__(self, level: int, rows: int):
        n = rows << level
        self.key = (level, rows)
        self.col = np.zeros(max(rows, 1), dtype=np.int16)
        self.kbuf = _aligned_zeros(n, np.int16)
        # + cols headroom: per-pass history prepended by synth_block_host;
        # the DATA area (base + cols words) is 64B-aligned because the
        # base is and cols*4 % 64 == 0 whenever the AVX gate (level >= 4)
        # can engage
        self.xbuf = _aligned_zeros(n + (1 << level), np.uint32)
        self.ybuf = _aligned_zeros(n + (1 << level), np.uint32)
        self.meta = np.zeros(16, dtype=np.int64)
        # ctypes pointers computed ONCE where the arrays are assigned
        # (a .ctypes.data_as per array per call was ~10% of the host
        # path's Python-side cost at 12 pointers per decoded file)
        self.col_p = _ptr(self.col, ctypes.c_int16)
        self.kbuf_p = _ptr(self.kbuf, ctypes.c_int16)
        self.xbuf_p = _ptr(self.xbuf, ctypes.c_uint32)
        self.ybuf_p = _ptr(self.ybuf, ctypes.c_uint32)
        self.meta_p = _ptr(self.meta, ctypes.c_int64)
        self._max_events = 0

    def event_bufs(self, max_events: int):
        """(events, tell, ev_pwr, ev_val) scratch, grown geometrically.

        Only the [:n_events] slices are copied out of these, so reuse is
        safe — and it matters: fresh multi-100-KB zeroed arrays per file
        were pure page-fault cost (~40% of the host corpus decode's
        Python-side overhead)."""
        if self._max_events < max_events:
            self._max_events = max(max_events, 2 * self._max_events)
            self.events = np.empty(self._max_events, dtype=np.int16)
            self.tell = np.empty(self._max_events, dtype=np.int64)
            self.ev_pwr = np.empty(self._max_events, dtype=np.uint8)
            self.ev_val = np.empty(self._max_events, dtype=np.uint16)
            self.events_p = _ptr(self.events, ctypes.c_int16)
            self.tell_p = _ptr(self.tell, ctypes.c_int64)
            self.ev_pwr_p = _ptr(self.ev_pwr, ctypes.c_uint8)
            self.ev_val_p = _ptr(self.ev_val, ctypes.c_uint16)
        return self.events, self.tell, self.ev_pwr, self.ev_val


def _acquire_pcm(n: int) -> np.ndarray:
    """int16 PCM output buffer from a refcount-gated freelist.

    A fresh np.empty per decoded file makes the kernel zero-fault every
    output page inside the native call (~1.4 ms per 1.2 MB file — as much
    as the decode itself on a warm benchmark loop). Instead, buffers are
    pooled per rounded size and reused once the caller has dropped every
    reference (slices keep the base alive, so getrefcount on the base is
    an exact liveness test). Thread-local, like the other scan scratch.

    The returned view's data pointer is 64-byte aligned (numpy only
    guarantees 16): the batched corpus decode's non-temporal PCM stores
    need 32-byte-aligned per-file destinations, which the batch builds as
    aligned base + 64-byte-rounded offsets. The pool stores the OWNING
    arrays (a slice's .base is the owner, so the refcount gate stays
    exact); the alignment offset is recomputed per acquisition."""
    cap = _round_up_pool(n + 32)
    pool: dict[int, list] | None = getattr(_SCRATCH_TLS, "pcm_pool", None)
    if pool is None:
        pool = _SCRATCH_TLS.pcm_pool = {}
    lst = pool.setdefault(cap, [])

    def _aligned_view(a: np.ndarray) -> np.ndarray:
        off = (-a.ctypes.data % 64) // 2
        return a[off : off + n]

    for a in lst:
        # refs: the list slot, the loop variable, the getrefcount argument
        if sys.getrefcount(a) == 3:
            return _aligned_view(a)
    # corpus-sized bound: a whole decode's outputs are typically live at
    # once (the caller holds every FileResult), so reuse only pays across
    # runs — track enough buffers for a large chunk, then stop (gc
    # reclaims untracked ones when the caller drops them)
    if len(lst) >= 256:
        lst[:] = [a for a in lst if sys.getrefcount(a) == 3][:128]
    a = np.empty(cap, dtype=np.int16)
    lst.append(a)
    return _aligned_view(a)


def _round_up_pool(n: int) -> int:
    step = max(1 << 16, 1 << (max(n.bit_length(), 4) - 3))
    return -(-n // step) * step


# Thread-local: the GIL is released during acm_decode_host, so concurrent
# decode_host/synth_dense calls (decode_corpus from two threads, parallel
# windowed streams) would otherwise share and corrupt one scratch set.
_SCRATCH_TLS = threading.local()


def _scratch(level: int, rows: int) -> HostDecodeScratch:
    cache: dict[tuple[int, int], HostDecodeScratch] | None = getattr(
        _SCRATCH_TLS, "cache", None)
    if cache is None:
        cache = _SCRATCH_TLS.cache = {}
    s = cache.get((level, rows))
    if s is None:
        if len(cache) > 64:
            cache.clear()
        s = cache[(level, rows)] = HostDecodeScratch(level, rows)
    return s


@dataclasses.dataclass
class AmpTable:
    """Virtual stale-amp-table state threaded across decode windows.

    One `val` per exponent (the reference's persistent 64 Ki table holds
    k * (val of the most recent attempt covering k); see SynthEmitter in
    _scan.cpp). Zero/uncovered at stream start = the reference's
    calloc-zeroed table.
    """

    val: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(17, dtype=np.uint32))
    cov: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(17, dtype=np.int64))


def _decode_host_raw(
    lib, data, hdr: AcmHeader, max_blocks: int, max_events: int,
    start_bit: int, wrap: np.ndarray, final: bool, table: AmpTable | None,
) -> HostDecode:
    rows, cols = hdr.rows, hdr.cols
    s = _scratch(hdr.level, rows)
    pcm = _acquire_pcm(max_blocks * rows * cols)
    events, tell, ev_pwr, ev_val = s.event_bufs(max_events)
    # zero-copy uint8 view: accepts bytes, bytearray, or memoryview (the
    # buffer must stay unmutated for the GIL-released call — windowed
    # streams are single-threaded per stream). _raw_ptr, not _ptr: the
    # windowed caller GROWS its bytearray after this returns, so the
    # buffer export must release at return, not at the next gc.
    dview = np.frombuffer(data, dtype=np.uint8)
    rc = lib.acm_decode_host(
        _raw_ptr(dview, ctypes.c_uint8), len(dview),
        start_bit, hdr.level, rows, max_blocks, max_events,
        _ptr(pcm, ctypes.c_int16), _ptr(wrap, ctypes.c_uint32),
        s.events_p, s.tell_p,
        s.col_p, s.kbuf_p, s.xbuf_p, s.ybuf_p, s.meta_p,
        1 if final else 0,
        _ptr(table.val, ctypes.c_uint32) if table is not None else None,
        _ptr(table.cov, ctypes.c_int64) if table is not None else None,
        s.ev_pwr_p, s.ev_val_p,
    )
    if rc != 0:
        raise RuntimeError("host decode: event capacity exceeded")
    m = s.meta
    n_good = int(m[0])
    n_events = int(m[1])
    return HostDecode(
        header=hdr,
        pcm=pcm[: n_good * rows * cols],
        n_good=n_good,
        first_err=int(m[8]),
        events=events[:n_events].copy(),
        status=int(m[2]),
        oor=bool(m[9]),
        end_bit=int(m[10]),
        wrap=wrap,
        ev_bits=tell[:n_events].copy(),
        ev_pwr=ev_pwr[:n_events].copy(),
        ev_val=ev_val[:n_events].copy(),
        term_att=((int(ev_pwr[n_events]), int(ev_val[n_events]))
                  if m[11] else None),
    )


def decode_host(
    data: bytes,
    header: AcmHeader | None = None,
    max_blocks: int | None = None,
    start_bit: int | None = None,
    wrap: np.ndarray | None = None,
) -> HostDecode:
    """Fused single-pass host decode: scan + filterbank + int16 PCM.

    The host-output fast path (the reference's whole per-block pipeline,
    decode.c:580-625, in one cache-resident C++ sweep). `start_bit`/`wrap`
    resume a previous window's `end_bit`/`wrap` for bounded-memory
    streaming decode; by default decodes the whole stream from the header.
    Bit-exact even on hostile streams with out-of-range coefficient
    indexes (the stale-amp-table reads are reproduced natively; `oor` is
    informational). NOTE: a mid-stream `start_bit` resume reproduces the
    one-shot decode only when the amp-table state is also threaded — use
    `decode_host_window` for that; this convenience entry starts with a
    fresh (stream-start) table.
    """
    lib, hdr, max_blocks, skip_bits, max_events = _prep(data, max_blocks,
                                                        header)
    if start_bit is None:
        start_bit = skip_bits
    if wrap is None:
        wrap = np.zeros(max(2 * hdr.cols - 2, 1), dtype=np.uint32)
    return _decode_host_raw(lib, data, hdr, max_blocks, max_events,
                            start_bit, wrap, final=True, table=None)


#: decode_corpus_host_batch per-file result: events is a view into the
#: call's arena, pcm a view into the pooled PCM arena (the arena stays
#: alive exactly as long as any view — same refcount-gated contract as
#: decode_host's pooled buffer). `overflowed=True` means the file's
#: attempt count exceeded its event slot (heavily corrupt stream): the
#: caller must rescan it solo via decode_host.
@dataclasses.dataclass
class BatchFile:
    n_good: int
    first_err: int
    events: np.ndarray | None
    pcm: np.ndarray | None
    overflowed: bool = False


def decode_corpus_host_batch(
    blobs: "list[bytes]", headers: "list[AcmHeader]",
) -> "list[BatchFile]":
    """Fused host decode of many independent streams in ONE native call.

    Semantically identical to `decode_host(blob, header)` per file (fresh
    wrap carry + fresh stream-start amp table each), but the whole corpus
    chunk crosses the ctypes boundary once: the per-file Python/ctypes
    round trip (scratch lookup, pcm pool, pointer marshaling, HostDecode
    assembly — ~25% of end-to-end corpus wall at ~200 files) collapses
    into one GIL-released sweep. This is the reference CLI's whole
    multi-file session (acmtool.c:241-291) as a single native batch.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native scanner not available")
    n = len(blobs)
    if n == 0:
        return []
    levels = np.empty(n, np.int32)
    rowss = np.empty(n, np.int32)
    lens = np.empty(n, np.int64)
    skips = np.empty(n, np.int64)
    maxb = np.empty(n, np.int64)
    pcm_off = np.empty(n + 1, np.int64)
    ev_off = np.empty(n + 1, np.int64)
    pcm_off[0] = ev_off[0] = 0
    max_ev = 64
    max_rows = 1
    max_n = 1
    max_cols = 1
    for j, (b, h) in enumerate(zip(blobs, headers)):
        # byte-capped block bound, exactly as _prep computes it
        nb = min(h.n_blocks, (8 * (len(b) + 1)) // (20 + 5 * h.cols) + 2)
        levels[j] = h.level
        rowss[j] = h.rows
        lens[j] = len(b)
        skips[j] = 8 * (ACM_HEADER_LEN
                        + (WAVC_HEADER_LEN if h.wavc_file else 0))
        maxb[j] = nb
        # 32-elem (64-byte) rounding keeps every file's PCM destination
        # aligned for the native batch's non-temporal stores (the arena
        # base is 64-byte aligned by _acquire_pcm)
        pcm_off[j + 1] = pcm_off[j] + -(-(nb * h.rows * h.cols) // 32) * 32
        # one event per attempt; clean/truncated streams stay within
        # blocks + a few trailing attempts, and the 2x headroom absorbs
        # moderately corrupt ones (bit flips produce failed attempts
        # beyond the block count) — streams that still exceed it
        # overflow to a solo rescan (rare)
        ev_off[j + 1] = ev_off[j] + 2 * nb + 16
        max_ev = max(max_ev, (8 * (len(b) + 1)) // 20 + 4)
        max_rows = max(max_rows, h.rows)
        max_n = max(max_n, h.rows * h.cols)
        max_cols = max(max_cols, h.cols)
    pcm = _acquire_pcm(int(pcm_off[n]))
    events_arena = np.empty(int(ev_off[n]), np.int16)
    ev_scratch = np.empty(max_ev, np.int16)
    tell_scratch = np.empty(max_ev, np.int64)
    col_tmp = np.empty(max_rows, np.int16)
    kbuf = _aligned_zeros(max_n, np.int16)
    xbuf = _aligned_zeros(max_n + max_cols, np.uint32)
    ybuf = _aligned_zeros(max_n + max_cols, np.uint32)
    wrap = np.zeros(max(2 * max_cols - 2, 1), np.uint32)
    out = np.zeros(n * 4, np.int64)
    datas = (ctypes.c_char_p * n)(*blobs)
    rc = lib.acm_decode_corpus_host_batch(
        datas, _ptr(lens, ctypes.c_int64), _ptr(skips, ctypes.c_int64),
        _ptr(maxb, ctypes.c_int64), _ptr(levels, ctypes.c_int32),
        _ptr(rowss, ctypes.c_int32), n,
        _ptr(pcm, ctypes.c_int16), _ptr(pcm_off, ctypes.c_int64),
        _ptr(events_arena, ctypes.c_int16), _ptr(ev_off, ctypes.c_int64),
        _ptr(ev_scratch, ctypes.c_int16), _ptr(tell_scratch, ctypes.c_int64),
        int(max_ev),
        _ptr(col_tmp, ctypes.c_int16), _ptr(kbuf, ctypes.c_int16),
        _ptr(xbuf, ctypes.c_uint32), _ptr(ybuf, ctypes.c_uint32),
        _ptr(wrap, ctypes.c_uint32), _ptr(out, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"batched host decode failed at file {-rc - 1}")
    results: list[BatchFile] = []
    for j in range(n):
        ng = int(out[4 * j])
        if out[4 * j + 3]:
            results.append(BatchFile(0, 0, None, None, overflowed=True))
            continue
        ne = int(out[4 * j + 2])
        eo = int(ev_off[j])
        po = int(pcm_off[j])
        block = int(rowss[j]) << int(levels[j])
        results.append(BatchFile(
            n_good=ng, first_err=int(out[4 * j + 1]),
            events=events_arena[eo : eo + ne],
            pcm=pcm[po : po + ng * block],
        ))
    return results


def decode_host_window(
    buf: bytes | bytearray,
    level: int,
    rows: int,
    start_bit: int,
    wrap: np.ndarray,
    table: AmpTable,
    max_blocks: int,
    final: bool,
    wavc_file: bool = False,
) -> HostDecode:
    """Windowed host decode over a partial buffer (bounded-memory streaming).

    `buf` is a byte window of the stream (its bit 0 at some absolute
    stream position the caller tracks); `start_bit` is relative to `buf`.
    `final=False` means more bytes may follow: no phantom EOF byte is
    assumed, and running dry rolls the attempt back, returning status
    NEED_MORE_DATA with `end_bit` = the retry position. `wrap` (uint32
    [2*cols-2], updated in place) and `table` thread the filterbank carry
    and stale-amp-table state across windows; threaded this way, windowed
    decode is byte-identical to a one-shot decode (tested in
    tests/test_stream_windowed.py). The reference streams with the same
    O(64 KiB + block) footprint (decode.c:29,41-67).
    """
    lib = _load()
    assert lib is not None
    hdr = AcmHeader(total_values=1, channels=1, rate=4096, level=level,
                    rows=rows, wavc_file=wavc_file)
    byte_cap = (8 * (len(buf) + 1)) // (20 + 5 * hdr.cols) + 2
    max_blocks = min(max_blocks, byte_cap)
    max_events = (8 * (len(buf) + 1)) // 20 + 4
    return _decode_host_raw(lib, buf, hdr, max_blocks, max_events,
                            start_bit, wrap, final=final, table=table)


def synth_dense(
    k: np.ndarray,  # int16 [nb, rows, cols] (C-contiguous)
    vals: np.ndarray,  # uint16 [nb]
    level: int,
    rows: int,
    wrap: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host synth of already-scanned dense blocks → (pcm int16 [nb, n], wrap).

    The streaming path's host back-end (same math as ops.synth_jax but on
    the CPU, for host-bound output); `wrap` is updated in place if given.
    """
    lib = _load()
    assert lib is not None
    cols = 1 << level
    nb = k.shape[0]
    if wrap is None:
        wrap = np.zeros(max(2 * cols - 2, 1), dtype=np.uint32)
    k = np.ascontiguousarray(k, dtype=np.int16)
    vals = np.ascontiguousarray(vals, dtype=np.uint16)
    s = _scratch(level, rows)
    pcm = np.empty((nb, rows * cols), dtype=np.int16)
    lib.acm_synth_dense(
        _ptr(k, ctypes.c_int16), _ptr(vals, ctypes.c_uint16), nb, level, rows,
        _ptr(wrap, ctypes.c_uint32), s.xbuf_p, s.ybuf_p,
        _ptr(pcm, ctypes.c_int16),
    )
    return pcm, wrap
