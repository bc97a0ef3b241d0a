// The port's native scanner library: the scanner it shares with the JAX
// package (_scan.cpp, included whole and kept byte-identical to
// libacm_tpu/scan/_scan.cpp) and the port's own entry for random access.
// scan/native.py builds this file; one translation unit, so the entry
// calls the shared scan core (scan_driver<PackedEmitter>) directly.
//
// acm_scan_crops prepares a whole RandomAccessCorpus.read_batch in one
// GIL-free call: plan, span scans in place in the clips' bytes, and the
// batch's wire and metadata laid out in the caller's (pinned) blob. It is
// kept apart from acm_scan_corpus_chunk: ingest scans whole files with
// event lists and an overflow rescan; a crop needs a start bit, the plan
// and a layout into the caller's blob.

#include "_scan.cpp"

#include <vector>

namespace {

// A clip's row in the caller's table of clips (int64 fields, in order).
enum : int {
  CLIP_DATA,        // address of the clip's bytes
  CLIP_NBYTES,
  CLIP_BITPOS,      // address of its BlockIndex's int64 [n_good] block bits
  CLIP_NGOOD,
  CLIP_TOTAL,       // total_values
  CLIP_LEVEL,
  CLIP_ROWS,
  CLIP_DATA_START,  // byte where the bitstream begins
  CLIP_CH,          // channel count the clip is read with
  CLIP_OOR,         // stale-amp-table stream: its crops decode on the host
  CLIP_FIELDS
};

// What acm_scan_crops made of a crop (its CROP_INFO row's first field).
enum : int64_t {
  CROP_DEVICE = 0,  // planned, scanned and laid out for the card
  CROP_HOST = 1,    // a host row: stale-amp-table clip, or nothing decodable
  CROP_STALE = 2,   // its span decoded fewer blocks than the index says
  CROP_PAST = 3,    // its span starts past the clip's bytes
  CROP_PAD = 4,     // frames missing and padding refused
};

constexpr int64_t CROP_HEAD = 8, CROP_GEOM = 16, CROP_INFO = 8;
constexpr int64_t CROP_ALIGN = 256;  // of each geometry's wire in the blob

inline int64_t round_up64(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

// Bytes of a wire stream that cross to the card: its used bytes and two
// more, rounded up to 256 within its capacity, even (the unpack reads
// uint16 pairs) -- the lengths the unpack kernel is given.
inline int64_t crop_wire_len(int64_t used, int64_t cap) {
  const int64_t n = std::min(round_up64(used + 2, 256), cap);
  return n - (n & 1);
}

// native.pay_stream_caps: pay4, pay8, pay16 and width-nibble capacities
inline void crop_stream_caps(int64_t ncols, int rows, int64_t caps[4]) {
  for (int k = 0; k < 3; k++) {
    const int64_t n = (ncols * rows * (4 << k) + 7) / 8 + 16;  // PAY_SLACK
    caps[k] = n + (n & 1);
  }
  caps[3] = (ncols + 1) / 2 + 8;
}

// A stream's used bytes into the blob, its last byte's unused high bits and
// the rest of its length zeroed (the scratch may hold an older scan's bytes)
inline uint8_t* crop_put_stream(uint8_t* dst, const uint8_t* src,
                                int64_t used, int64_t len, uint8_t last_mask) {
  std::memcpy(dst, src, used);
  if (used > 0) dst[used - 1] &= last_mask;
  std::memset(dst + used, 0, len - used);
  return dst + len;
}

struct CropGroup {
  int level, rows;
  int64_t count, need, warm, blocks, first;
  bool short_crop;
};

// One thread's scratch: a geometry's streams before they are laid out, and
// the scan driver's event lists (grown, never shrunk)
struct CropScratch {
  std::vector<uint8_t> pay[3], wid[3], pwr;
  std::vector<uint16_t> vals;
  std::vector<int16_t> events, col;
  std::vector<int64_t> tell, pos;
  std::vector<CropGroup> groups;
};
thread_local CropScratch crop_scratch;

template <typename T>
inline T* crop_grown(std::vector<T>& v, int64_t n) {
  if (static_cast<int64_t>(v.size()) < n) v.resize(n);
  return v.data();
}

}  // namespace

extern "C" {

// Random access: a whole RandomAccessCorpus.read_batch prepared in one call.
//   clips [n * CLIP_FIELDS]: each crop's clip (the caller keeps the bytes
//   and the block index alive; one channel count ch, read from crop 0);
//   starts [n]: first frames (negative reads as 0). A crop is `frames`
//   frames, want = frames * ch words.
// The port's one crop plan, which every random-access read on either route
// reads: each crop's whole frames that exist (the valid-word clamp); blocks
// [a0, a0 + nb) with 1 warm-up block for rows >= 2 and the whole prefix for
// rows == 1 (the warm-up rule); lo, its first word in them. A null blob
// (blob == nullptr, cap == 0) asks for the plan only: the CROP_INFO rows are
// filled (blocks decoded left 0) and the call returns; nothing is scanned
// or laid out, and the head and the geometry rows stay zero but for the
// status. Otherwise crops on the card are grouped by (level, rows) in order
// of first appearance, each span scanned in place from its warm-up block's
// bit, and blob [cap] laid out as:
//   per geometry, at CROP_ALIGN offsets, the nine cols-wire sections of a
//   [count, nbp] launch (ops.synth_torch.cols_blob_layout: cls, pay4/8/16,
//   wid4/8/16, vals, wrap0), nbp = the most blocks a row needs (its span,
//   or lo + want words) rounded up to 8;
//   then 2 * want bytes a host row, for the caller to fill, 8-aligned;
//   then int64 metadata: each geometry's crops' lo, then their valid
//   words; then each crop's place in that order (geometries, then host
//   rows) where the order is not the batch's.
// out: CROP_HEAD int64: status, total bytes, geometries, host rows, host
//   rows' offset, metadata offset, crops on the card, order present; then
//   CROP_GEOM a geometry: level, rows, count, nbp, offset, size, the six
//   stream lengths, warm-up blocks, pad blocks, a crop short of want, the
//   first crop's lo; then CROP_INFO a crop (n of them, after n geometry
//   rows): code (CROP_*), geometry (-1 if none), start word, valid words,
//   blocks, blocks decoded, lo, warm-up blocks.
// Returns the status: 0 done (or planned, for a null blob); 1 a crop is
// short and pad is 0 (nothing scanned); 2 a span is stale (scanning stopped
// after its geometry); 3 blob is too small, out[1] = the bytes it needs
// (nothing scanned).
int64_t acm_scan_crops(const int64_t* clips, const int64_t* starts,
                       int64_t n, int64_t frames, int32_t pad, uint8_t* blob,
                       int64_t cap, int64_t* out) {
  CropScratch& s = crop_scratch;
  int64_t* head = out;
  int64_t* geo = out + CROP_HEAD;
  int64_t* info = geo + CROP_GEOM * n;
  std::memset(out, 0,
              sizeof(int64_t) * (CROP_HEAD + (CROP_GEOM + CROP_INFO) * n));
  const int64_t ch = clips[CLIP_CH];
  const int64_t want = frames * ch;

  // the plan
  std::vector<CropGroup>& groups = s.groups;
  groups.clear();
  int64_t n_host = 0, n_dev = 0;
  bool refused = false;
  for (int64_t j = 0; j < n; j++) {
    const int64_t* c = clips + j * CLIP_FIELDS;
    int64_t* f = info + j * CROP_INFO;
    const int level = static_cast<int>(c[CLIP_LEVEL]);
    const int rows = static_cast<int>(c[CLIP_ROWS]);
    const int64_t bl = static_cast<int64_t>(rows) << level;
    const int64_t end = std::min(c[CLIP_TOTAL], c[CLIP_NGOOD] * bl);
    const int64_t first = std::max<int64_t>(starts[j], 0);
    // a first frame at or past the end leaves nothing valid either way
    const int64_t sw = first >= end ? end : first * ch;
    const int64_t stop = std::min(sw + want, end);
    int64_t valid = std::max<int64_t>(0, stop - sw);
    valid -= valid % ch;
    f[1] = -1;
    f[2] = sw;
    f[3] = valid;
    if (valid < want && !pad) {
      f[0] = CROP_PAD;
      refused = true;
      continue;
    }
    if (valid == 0 || c[CLIP_OOR]) {
      f[0] = CROP_HOST;
      n_host++;
      continue;
    }
    const int64_t a = sw / bl, b = (stop + bl - 1) / bl;
    const int64_t warm = (a > 0 && rows >= 2) ? 1 : a;
    const int64_t a0 = a - warm, nb = b - a0, lo = sw - a0 * bl;
    int64_t g = 0;
    while (g < static_cast<int64_t>(groups.size()) &&
           (groups[g].level != level || groups[g].rows != rows))
      g++;
    if (g == static_cast<int64_t>(groups.size()))
      groups.push_back(CropGroup{level, rows, 0, 0, 0, 0, j, false});
    CropGroup& G = groups[g];
    G.count++;
    G.need = std::max(G.need, std::max(nb, (lo + want + bl - 1) / bl));
    G.warm += warm;
    G.blocks += nb;
    G.short_crop |= valid < want;
    f[0] = CROP_DEVICE;
    f[1] = g;
    f[4] = nb;
    f[6] = lo;
    f[7] = warm;
    n_dev++;
  }
  if (refused) return head[0] = 1;
  if (blob == nullptr) return head[0] = 0;  // the plan only

  // each crop's place in the order geometries, then host rows
  const int64_t n_groups = static_cast<int64_t>(groups.size());
  int64_t* pos = crop_grown(s.pos, n + n_groups);
  int64_t* next = pos + n;
  int64_t at = 0;
  for (int64_t g = 0; g < n_groups; g++) {
    next[g] = at;
    at += groups[g].count;
  }
  bool in_order = true;
  for (int64_t j = 0; j < n; j++) {
    const int64_t g = info[j * CROP_INFO + 1];
    pos[j] = g < 0 ? at++ : next[g]++;
    in_order &= pos[j] == j;
  }

  // the most bytes the layout can take: the streams' lengths are at most
  // their used bytes + 257, and a column's rows * w bits lie in one stream
  // (w <= 16), its width nibble in one width stream
  int64_t worst = 0;
  for (const CropGroup& G : groups) {
    const int64_t nbp = round_up64(G.need, 8);
    const int64_t cols = int64_t{1} << G.level;
    const int64_t ncols = G.count * nbp * cols;
    int64_t caps[4];
    crop_stream_caps(ncols, G.rows, caps);
    const int64_t pays = std::min(caps[0] + caps[1] + caps[2],
                                  2 * ncols * G.rows + 3 * 260);
    const int64_t wids = std::min(3 * caps[3], (ncols + 1) / 2 + 3 * 260);
    worst = round_up64(worst + G.count * nbp * ((cols + 3) / 4) + pays + wids
                       + 2 * G.count * nbp + 4 * G.count * (2 * cols - 2),
                       CROP_ALIGN);
  }
  worst = round_up64(worst + 2 * want * n_host, 8)
          + 8 * (2 * n_dev + (in_order ? 0 : n));
  if (worst > cap) {
    head[1] = worst;
    return head[0] = 3;
  }

  // the scans, a geometry at a time, and its sections into the blob
  int64_t off = 0;
  for (int64_t g = 0; g < n_groups; g++) {
    const CropGroup& G = groups[g];
    const int cols = 1 << G.level;
    const int64_t stride = (cols + 3) / 4, wlen = 2 * cols - 2;
    const int64_t nbp = round_up64(G.need, 8);
    const int64_t slots = G.count * nbp;
    const int64_t bl = static_cast<int64_t>(G.rows) << G.level;
    int64_t caps[4];
    crop_stream_caps(slots * cols, G.rows, caps);
    uint8_t* pay[3];
    uint8_t* wid[3];
    for (int k = 0; k < 3; k++) {
      pay[k] = crop_grown(s.pay[k], caps[k]);
      wid[k] = crop_grown(s.wid[k], caps[3]);
    }
    uint8_t* pwr = crop_grown(s.pwr, slots);
    uint16_t* vals = crop_grown(s.vals, slots);
    std::memset(vals, 0, slots * sizeof(uint16_t));
    int16_t* col = crop_grown(s.col, G.rows);
    uint8_t* cls = blob + off;
    std::memset(cls, 0, slots * stride);
    int64_t obits[3] = {0, 0, 0}, ocol[3] = {0, 0, 0};
    bool stale = false;
    int64_t k = 0;
    for (int64_t j = G.first; j < n; j++) {
      int64_t* f = info + j * CROP_INFO;
      if (f[1] != g) continue;
      const int64_t* c = clips + j * CLIP_FIELDS;
      const int64_t slot = k++;
      const int64_t nb = f[4];
      const int64_t a0 = f[2] / bl - f[7];
      const auto* data = reinterpret_cast<const uint8_t*>(c[CLIP_DATA]);
      const int64_t nbytes = c[CLIP_NBYTES];
      const auto* bitpos = reinterpret_cast<const int64_t*>(c[CLIP_BITPOS]);
      const int64_t skip = a0 ? bitpos[a0] : 8 * c[CLIP_DATA_START];
      if (skip >= 8 * nbytes) {
        f[0] = CROP_PAST;
        stale = true;
        continue;
      }
      // every attempt takes >= 20 bits, and a span that fits its index
      // ends by the next indexed block's bit
      const int64_t stop_bit = a0 + nb < c[CLIP_NGOOD] ? bitpos[a0 + nb]
                                                       : 8 * (nbytes + 1);
      const int64_t max_events =
          std::max<int64_t>(stop_bit - skip, 0) / 20 + nb + 8;
      int16_t* events = crop_grown(s.events, max_events);
      int64_t* tell = crop_grown(s.tell, max_events);
      PackedEmitter em{cls + slot * nbp * stride, {pay[0], pay[1], pay[2]},
                       {wid[0], wid[1], wid[2]}, pwr + slot * nbp,
                       vals + slot * nbp, G.rows, cols};
      for (int q = 0; q < 3; q++) {
        em.bits[q] = em.sbits[q] = obits[q];
        em.ncol[q] = em.sncol[q] = ocol[q];
      }
      int64_t fmeta[16] = {0};
      const int64_t rc = scan_driver<PackedEmitter, /*FAST=*/true>(
          data, nbytes, skip, G.level, G.rows, cols, nb, max_events, events,
          tell, fmeta, col, em, /*stop_on_error=*/false);
      f[5] = fmeta[0];
      if (rc != 0 || fmeta[0] < nb) {
        f[0] = CROP_STALE;
        stale = true;
      }
      for (int q = 0; q < 3; q++) {
        obits[q] = em.bits[q];
        ocol[q] = em.ncol[q];
      }
    }
    if (stale) return head[0] = 2;

    int64_t* row = geo + g * CROP_GEOM;
    uint8_t* p = cls + slots * stride;
    for (int q = 0; q < 3; q++) {
      const int64_t used = (obits[q] + 7) / 8;
      row[6 + q] = crop_wire_len(used, caps[q]);
      const int tail = static_cast<int>(obits[q] & 7);
      p = crop_put_stream(p, pay[q], used, row[6 + q],
                          tail ? static_cast<uint8_t>((1u << tail) - 1) : 0xFF);
    }
    for (int q = 0; q < 3; q++) {
      const int64_t used = (ocol[q] + 1) / 2;
      row[9 + q] = crop_wire_len(used, caps[3]);
      p = crop_put_stream(p, wid[q], used, row[9 + q],
                          (ocol[q] & 1) ? 0x0F : 0xFF);
    }
    std::memcpy(p, vals, slots * sizeof(uint16_t));
    p += slots * sizeof(uint16_t);
    std::memset(p, 0, 4 * G.count * wlen);
    p += 4 * G.count * wlen;
    row[0] = G.level;
    row[1] = G.rows;
    row[2] = G.count;
    row[3] = nbp;
    row[4] = off;
    row[5] = p - cls;
    row[12] = G.warm;
    row[13] = slots - G.blocks;
    row[14] = G.short_crop;
    row[15] = info[G.first * CROP_INFO + 6];
    off = round_up64(off + row[5], CROP_ALIGN);
  }

  const int64_t host_off = off;
  const int64_t meta_off = round_up64(off + 2 * want * n_host, 8);
  uint8_t* meta = blob + meta_off;
  auto put = [&meta](int64_t v) {
    std::memcpy(meta, &v, sizeof v);
    meta += sizeof v;
  };
  for (int64_t g = 0; g < n_groups; g++) {
    for (int field : {6, 3}) {  // lo, then valid
      for (int64_t j = groups[g].first; j < n; j++)
        if (info[j * CROP_INFO + 1] == g) put(info[j * CROP_INFO + field]);
    }
  }
  if (!in_order)
    for (int64_t j = 0; j < n; j++) put(pos[j]);
  head[1] = meta - blob;
  head[2] = n_groups;
  head[3] = n_host;
  head[4] = host_off;
  head[5] = meta_off;
  head[6] = n_dev;
  head[7] = !in_order;
  return head[0] = 0;
}

}  // extern "C"
