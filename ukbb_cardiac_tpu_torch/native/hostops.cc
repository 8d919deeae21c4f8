// Native host-side ops of ukbb_cardiac_tpu_torch: a copy of
// ukbb_cardiac_tpu/native/hostops.cc (the port imports nothing of the JAX
// package, so it keeps its own), with one section more,
// count_significant_cc_frames, the aortic QC's pass over a cine's frames,
// and without the JAX package's up-leg packer.
//
// The port binds every entry point through ctypes (native/__init__.py),
// which builds this file with g++ at first use: dicom_scan (the DICOM
// element walker for the Biobank attribute subset), jpeg_sof3_decode
// (JPEG lossless, SOF3) and jpegls_decode (JPEG-LS) for ingestion; the
// connected-component passes over cc_label_2d (largest_cc_2d,
// count_significant_cc_2d, remove_small_cc_2d) for the 2D masks of
// ops/cc.py, and label_areas_per_frame; unpack_bits for the engines' label
// readback.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Union-find over the pixel grid.
// ---------------------------------------------------------------------------

static inline int32_t uf_find(std::vector<int32_t>& parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

static inline void uf_union(std::vector<int32_t>& parent, int32_t a,
                            int32_t b) {
  a = uf_find(parent, a);
  b = uf_find(parent, b);
  if (a != b) parent[b] = a;
}

// Label a binary 2D image (row-major, shape ny x nx... caller passes
// dims; the algorithm is orientation-agnostic).  connectivity: 1 = faces,
// 2 = faces + diagonals.  Returns the number of components; labels out[i]
// in 1..n (0 = background).
int32_t cc_label_2d(const uint8_t* binary, int32_t nx, int32_t ny,
                    int32_t connectivity, int32_t* out) {
  const int64_t n = (int64_t)nx * ny;
  std::vector<int32_t> parent(n);
  for (int64_t i = 0; i < n; ++i) parent[i] = (int32_t)i;

  for (int32_t y = 0; y < ny; ++y) {
    for (int32_t x = 0; x < nx; ++x) {
      const int64_t i = (int64_t)y * nx + x;
      if (!binary[i]) continue;
      if (x > 0 && binary[i - 1]) uf_union(parent, (int32_t)i, (int32_t)(i - 1));
      if (y > 0 && binary[i - nx]) uf_union(parent, (int32_t)i, (int32_t)(i - nx));
      if (connectivity >= 2 && y > 0) {
        if (x > 0 && binary[i - nx - 1])
          uf_union(parent, (int32_t)i, (int32_t)(i - nx - 1));
        if (x < nx - 1 && binary[i - nx + 1])
          uf_union(parent, (int32_t)i, (int32_t)(i - nx + 1));
      }
    }
  }

  // compress to consecutive labels
  std::vector<int32_t> remap(n, 0);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!binary[i]) {
      out[i] = 0;
      continue;
    }
    int32_t root = uf_find(parent, (int32_t)i);
    if (remap[root] == 0) remap[root] = ++next;
    out[i] = remap[root];
  }
  return next;
}

// Component sizes: sizes[k-1] = pixel count of component k.
// sizes must have room for n_components entries (call cc_label_2d first).
void cc_sizes(const int32_t* labels, int64_t n, int32_t n_components,
              int64_t* sizes) {
  std::memset(sizes, 0, sizeof(int64_t) * n_components);
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] > 0) sizes[labels[i] - 1]++;
  }
}

// Largest connected component as a 0/1 mask. Returns its size (0 if none).
int64_t largest_cc_2d(const uint8_t* binary, int32_t nx, int32_t ny,
                      int32_t connectivity, uint8_t* out_mask) {
  const int64_t n = (int64_t)nx * ny;
  std::vector<int32_t> labels(n);
  int32_t nc = cc_label_2d(binary, nx, ny, connectivity, labels.data());
  if (nc == 0) {
    std::memset(out_mask, 0, n);
    return 0;
  }
  std::vector<int64_t> sizes(nc);
  cc_sizes(labels.data(), n, nc, sizes.data());
  int32_t best = 0;
  for (int32_t k = 1; k < nc; ++k)
    if (sizes[k] > sizes[best]) best = k;
  for (int64_t i = 0; i < n; ++i) out_mask[i] = (labels[i] == best + 1);
  return sizes[best];
}

// Number of components larger than pixel_thres (the QC fragmentation
// criterion, 8-connectivity in the reference).
int32_t count_significant_cc_2d(const uint8_t* binary, int32_t nx, int32_t ny,
                                int32_t connectivity, int64_t pixel_thres) {
  const int64_t n = (int64_t)nx * ny;
  std::vector<int32_t> labels(n);
  int32_t nc = cc_label_2d(binary, nx, ny, connectivity, labels.data());
  if (nc == 0) return 0;
  std::vector<int64_t> sizes(nc);
  cc_sizes(labels.data(), n, nc, sizes.data());
  int32_t count = 0;
  for (int32_t k = 0; k < nc; ++k)
    if (sizes[k] > pixel_thres) count++;
  return count;
}

// Zero out components smaller than thres pixels (remove_small_cc).
void remove_small_cc_2d(const uint8_t* binary, int32_t nx, int32_t ny,
                        int32_t connectivity, int64_t thres,
                        uint8_t* out_mask) {
  const int64_t n = (int64_t)nx * ny;
  std::vector<int32_t> labels(n);
  int32_t nc = cc_label_2d(binary, nx, ny, connectivity, labels.data());
  std::vector<int64_t> sizes(nc);
  if (nc > 0) cc_sizes(labels.data(), n, nc, sizes.data());
  for (int64_t i = 0; i < n; ++i) {
    out_mask[i] = (labels[i] > 0 && sizes[labels[i] - 1] >= thres);
  }
}

// Per-frame per-label counts: volume (X*Y*Z, T) flattened frame-major
// is awkward; instead caller passes stride so counts[t * n_labels + v].
void label_areas_per_frame(const int16_t* volume, int64_t frame_voxels,
                           int32_t n_frames, int32_t n_labels,
                           int64_t* counts) {
  std::memset(counts, 0, sizeof(int64_t) * n_labels * n_frames);
  for (int32_t t = 0; t < n_frames; ++t) {
    const int16_t* frame = volume + (int64_t)t * frame_voxels;
    int64_t* c = counts + (int64_t)t * n_labels;
    for (int64_t i = 0; i < frame_voxels; ++i) {
      int16_t v = frame[i];
      if (v >= 0 && v < n_labels) c[v]++;
    }
  }
}


// ---------------------------------------------------------------------------
// Components of one label over a stack of frames (the aortic QC's pass).
// ---------------------------------------------------------------------------

// Per-frame count of the components of (frame == label) larger than
// pixel_thres pixels, count_significant_cc_2d on every frame of a stack
// without building a mask, and each frame's area of the label.  labels
// holds n_frames frames of ny rows of nx, row-major, frame after frame (an
// (X, Y, 1, T) cine in Fortran order is such a stack with nx = X; the count
// is orientation-agnostic).  connectivity: 1 = faces, 2 = faces +
// diagonals.  counts and areas have n_frames entries.  Rows without the
// label are skipped after one compare pass the compiler vectorises; the
// others are cut into runs, each joined with the touching runs of the row
// above (uf_find over the runs, the size kept at each root).
void count_significant_cc_frames(const int16_t* labels, int32_t nx,
                                 int32_t ny, int32_t n_frames, int32_t label,
                                 int32_t connectivity, int64_t pixel_thres,
                                 int32_t* counts, int64_t* areas) {
  const int16_t lab = (int16_t)label;
  const int32_t reach = connectivity >= 2 ? 1 : 0;
  // runs of the frame: [start, end) in their row; parent and size per run
  std::vector<int32_t> start, end, parent;
  std::vector<int64_t> size;
  for (int32_t t = 0; t < n_frames; ++t) {
    const int16_t* frame = labels + (int64_t)t * nx * ny;
    start.clear();
    end.clear();
    parent.clear();
    size.clear();
    int64_t area = 0;
    int32_t prev_lo = 0, prev_hi = 0;  // the row above's runs [lo, hi)
    bool prev_row = false;             // whether that row is the one above
    for (int32_t y = 0; y < ny; ++y) {
      const int16_t* row = frame + (int64_t)y * nx;
      int32_t any = 0;
      for (int32_t x = 0; x < nx; ++x) any |= (row[x] == lab);
      if (!any) {
        prev_row = false;
        continue;
      }
      const int32_t lo = (int32_t)start.size();
      int32_t j = prev_row ? prev_lo : prev_hi;  // first candidate above
      int32_t x = 0;
      while (x < nx) {
        while (x < nx && row[x] != lab) ++x;
        if (x == nx) break;
        const int32_t s = x;
        while (x < nx && row[x] == lab) ++x;
        area += x - s;
        const int32_t r = (int32_t)start.size();
        start.push_back(s);
        end.push_back(x);
        parent.push_back(r);
        size.push_back(x - s);
        if (!prev_row) continue;
        // runs above that end before this one's reach cannot touch later
        // runs of this row either
        while (j < prev_hi && end[j] + reach <= s) ++j;
        for (int32_t k = j; k < prev_hi && start[k] < x + reach; ++k) {
          int32_t a = uf_find(parent, k);
          int32_t b = uf_find(parent, r);
          if (a != b) {
            parent[b] = a;
            size[a] += size[b];
          }
        }
      }
      prev_lo = lo;
      prev_hi = (int32_t)start.size();
      prev_row = true;
    }
    int32_t count = 0;
    for (int32_t r = 0; r < (int32_t)parent.size(); ++r)
      if (parent[r] == r && size[r] > pixel_thres) count++;
    counts[t] = count;
    areas[t] = area;
  }
}


// ---------------------------------------------------------------------------
// DICOM element scanner (data-loader fast path).
//
// Mirrors data/dicom.py::_parse_dataset exactly: walks an implicit- or
// explicit-VR little-endian dataset, records (tag_index, value_offset,
// value_length, vr_code) for the attribute subset Biobank_Dataset
// consumes, and skips items / undefined-length sequences.  Value decoding
// (ASCII numerics, backslash lists) stays in Python — the hot cost is the
// per-element walk over thousands of files, not the ~20 tiny decodes.
//
// Returns: number of entries written (>= 0); -1 for an unsupported
// transfer syntax or encapsulated (compressed) pixel data; -2 for a
// truncated / malformed stream.  vr_code is the two ASCII VR bytes packed
// little-endian, 0 in implicit-VR files.
// ---------------------------------------------------------------------------

// (group << 16) | element, ascending — MUST match _SCAN_NAMES in
// ukbb_cardiac_tpu/data/dicom.py.
static const uint32_t kDicomWanted[] = {
    0x00080018u,  // SOPInstanceUID
    0x0008103Eu,  // SeriesDescription
    0x00180050u,  // SliceThickness
    0x00180088u,  // SpacingBetweenSlices
    0x00181060u,  // TriggerTime
    0x00181090u,  // CardiacNumberOfImages
    0x0020000Eu,  // SeriesInstanceUID
    0x00200013u,  // InstanceNumber
    0x00200032u,  // ImagePositionPatient
    0x00200037u,  // ImageOrientationPatient
    0x00280002u,  // SamplesPerPixel
    0x00280008u,  // NumberOfFrames
    0x00280010u,  // Rows
    0x00280011u,  // Columns
    0x00280030u,  // PixelSpacing
    0x00280100u,  // BitsAllocated
    0x00280103u,  // PixelRepresentation
    0x00281052u,  // RescaleIntercept
    0x00281053u,  // RescaleSlope
    0x7FE00010u,  // PixelData
};
static const int kDicomWantedN =
    sizeof(kDicomWanted) / sizeof(kDicomWanted[0]);

static inline uint16_t rd16(const uint8_t* b, int64_t p) {
  return (uint16_t)(b[p] | (b[p + 1] << 8));
}
static inline uint32_t rd32(const uint8_t* b, int64_t p) {
  return (uint32_t)(b[p] | (b[p + 1] << 8) | (b[p + 2] << 16) |
                    ((uint32_t)b[p + 3] << 24));
}

static inline int dicom_tag_index(uint32_t key) {
  int lo = 0, hi = kDicomWantedN - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (kDicomWanted[mid] == key) return mid;
    if (kDicomWanted[mid] < key) lo = mid + 1; else hi = mid - 1;
  }
  return -1;
}

static inline bool dicom_long_vr(uint8_t a, uint8_t b) {
  // OB OW OF SQ UT UN — the explicit-VR forms with a 4-byte length
  return (a == 'O' && (b == 'B' || b == 'W' || b == 'F')) ||
         (a == 'S' && b == 'Q') || (a == 'U' && (b == 'T' || b == 'N'));
}

// twin of data/dicom.py::_skip_undefined
static int64_t dicom_skip_undefined(const uint8_t* b, int64_t n, int64_t pos,
                                    bool explicit_vr) {
  int depth = 1;
  while (pos + 8 <= n && depth > 0) {
    uint16_t group = rd16(b, pos), elem = rd16(b, pos + 2);
    if (group == 0xFFFE &&
        (elem == 0xE000 || elem == 0xE00D || elem == 0xE0DD)) {
      uint32_t length = rd32(b, pos + 4);
      pos += 8;
      if (elem == 0xE0DD) {
        depth -= 1;
      } else if (elem == 0xE000 && length != 0xFFFFFFFFu) {
        pos += length;
      }
      continue;
    }
    uint32_t length;
    if (explicit_vr) {
      uint8_t v0 = b[pos + 4], v1 = b[pos + 5];
      if (dicom_long_vr(v0, v1)) {
        if (pos + 12 > n) return n;  // truncated right after tag+VR
        length = rd32(b, pos + 8);
        pos += 12;
      } else {
        length = rd16(b, pos + 6);
        pos += 8;
      }
    } else {
      length = rd32(b, pos + 4);
      pos += 8;
    }
    if (length == 0xFFFFFFFFu) depth += 1;
    else pos += length;
  }
  return pos;
}

int64_t dicom_scan(const uint8_t* buf, int64_t n, int64_t* out,
                   int64_t out_cap) {
  int64_t pos = 0;
  bool explicit_vr = false;  // raw datasets default to implicit VR LE
  if (n >= 132 && memcmp(buf + 128, "DICM", 4) == 0) {
    pos = 132;
    char transfer[64];
    transfer[0] = '\0';
    while (pos + 8 <= n) {
      uint16_t group = rd16(buf, pos), elem = rd16(buf, pos + 2);
      if (group != 0x0002) break;
      uint8_t v0 = buf[pos + 4], v1 = buf[pos + 5];
      uint32_t length;
      int64_t hdr;
      if (dicom_long_vr(v0, v1)) {
        if (pos + 12 > n) return -2;  // truncated right after tag+VR
        length = rd32(buf, pos + 8);
        hdr = 12;
      } else {
        length = rd16(buf, pos + 6);
        hdr = 8;
      }
      if (group == 0x0002 && elem == 0x0010) {
        uint32_t m = length < 63 ? length : 63;
        if (pos + hdr + m > n) return -2;
        memcpy(transfer, buf + pos + hdr, m);
        transfer[m] = '\0';
        // strip trailing NUL/space padding
        for (int i = (int)m - 1;
             i >= 0 && (transfer[i] == '\0' || transfer[i] == ' '); --i)
          transfer[i] = '\0';
      }
      pos += hdr + length;
    }
    if (strcmp(transfer, "1.2.840.10008.1.2") == 0) explicit_vr = false;
    else if (strcmp(transfer, "1.2.840.10008.1.2.1") == 0) explicit_vr = true;
    else return -1;
  }

  int64_t count = 0;
  while (pos + 8 <= n) {
    uint16_t group = rd16(buf, pos), elem = rd16(buf, pos + 2);
    pos += 4;
    if (group == 0xFFFE && (elem == 0xE00D || elem == 0xE0DD)) {
      pos += 4;
      continue;
    }
    uint16_t vr_code = 0;
    uint32_t length;
    if (group == 0xFFFE && elem == 0xE000) {  // item inside SQ
      length = rd32(buf, pos);
      pos += 4;
      if (length == 0xFFFFFFFFu) pos = dicom_skip_undefined(buf, n, pos,
                                                            explicit_vr);
      else pos += length;
      continue;
    }
    if (explicit_vr) {
      uint8_t v0 = buf[pos], v1 = buf[pos + 1];
      vr_code = (uint16_t)(v0 | (v1 << 8));
      if (dicom_long_vr(v0, v1)) {
        if (pos + 8 > n) return -2;  // truncated right after tag+VR
        length = rd32(buf, pos + 4);
        pos += 8;
      } else {
        length = rd16(buf, pos + 2);
        pos += 4;
      }
    } else {
      length = rd32(buf, pos);
      pos += 4;
    }
    if (length == 0xFFFFFFFFu) {
      if (group == 0x7FE0 && elem == 0x0010) return -1;  // encapsulated
      pos = dicom_skip_undefined(buf, n, pos, explicit_vr);
      continue;
    }
    if (pos + (int64_t)length > n) return -2;
    int idx = dicom_tag_index(((uint32_t)group << 16) | elem);
    if (idx >= 0) {
      // table full: DECLINE (-2) so the caller uses the pure-Python
      // parser, instead of silently dropping later wanted tags (which
      // would lose PixelData first and invert duplicate-value rules)
      if (count >= out_cap) return -2;
      out[count * 4 + 0] = idx;
      out[count * 4 + 1] = pos;
      out[count * 4 + 2] = (int64_t)length;
      out[count * 4 + 3] = vr_code;
      ++count;
    }
    pos += length;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Compressed-DICOM pixel decoders: JPEG lossless (ITU-T T.81 Annex H,
// SOF3) and JPEG-LS (ITU-T T.87).  These are the per-pixel hot loops of
// converting compressed UKB re-releases (the reference degrades through
// SimpleITK, biobank_utils.py:352-363); the Python reference
// implementation lives in data/jpegcodec.py and the two are
// cross-checked bit-exactly in tests/test_native_jpeg.py.
// Return codes: >=0 ok, -1 malformed, -2 unsupported, -3 output too small.
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* buf;
  int64_t n;
  int64_t pos;
  uint64_t acc;
  int nbits;
  bool prev_ff;
  bool jls;  // JPEG-LS 7-bit stuffing vs JPEG 0x00 byte stuffing
  bool err;
};

static void br_fill(BitReader& r) {
  if (r.pos >= r.n) {  // tolerate missing final padding: zero bits
    r.acc <<= 8;
    r.nbits += 8;
    return;
  }
  uint8_t byte = r.buf[r.pos];
  if (!r.jls && r.prev_ff) {
    if (byte == 0x00) {  // stuffed byte after 0xFF
      r.pos++;
      r.prev_ff = false;
      br_fill(r);
      return;
    }
    r.err = true;  // marker inside entropy data
    r.acc <<= 8;
    r.nbits += 8;
    return;
  }
  r.pos++;
  if (r.jls && r.prev_ff) {
    r.acc = (r.acc << 7) | (byte & 0x7F);
    r.nbits += 7;
  } else {
    r.acc = (r.acc << 8) | byte;
    r.nbits += 8;
  }
  r.prev_ff = (byte == 0xFF);
}

static inline uint32_t br_read(BitReader& r, int nbits) {
  while (r.nbits < nbits) br_fill(r);
  int shift = r.nbits - nbits;
  uint32_t val = (uint32_t)((r.acc >> shift) & ((1u << nbits) - 1u));
  r.acc &= ((uint64_t)1 << shift) - 1;
  r.nbits = shift;
  return val;
}

static inline int br_unary(BitReader& r, int limit) {
  int count = 0;
  while (br_read(r, 1) == 0) {
    if (++count > limit || r.err) {
      r.err = true;
      return count;
    }
  }
  return count;
}

// --- JPEG lossless (SOF3) --------------------------------------------------

static inline int32_t sof3_predict(int32_t ra, int32_t rb, int32_t rc,
                                   int sv) {
  switch (sv) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;  // 7
  }
}

// Decode a single-component JPEG lossless (SOF3) stream into out
// (row-major uint16).  Writes image dims into *rows/*cols.
int32_t jpeg_sof3_decode(const uint8_t* data, int64_t n, uint16_t* out,
                         int64_t out_cap, int32_t* rows_out,
                         int32_t* cols_out) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  int64_t pos = 2;
  int P = 0, rows = 0, cols = 0, sv = 0, pt = 0, comp_table = 0;
  bool have_sof = false, have_sos = false;
  // Huffman tables keyed by id 0..3 (the SOS selects one)
  int bits_count[4][17] = {{0}};
  uint8_t huffval[4][64];
  int nsym[4] = {0, 0, 0, 0};
  int64_t entropy_start = -1;

  while (pos + 4 <= n) {
    if (data[pos] != 0xFF) return -1;
    uint8_t marker = data[pos + 1];
    if (marker == 0xD9) break;
    int length = (data[pos + 2] << 8) | data[pos + 3];
    const uint8_t* seg = data + pos + 4;
    int seg_len = length - 2;
    if (pos + 2 + length > n) return -1;
    if (marker == 0xC3) {
      if (seg_len < 8) return -1;
      P = seg[0];
      rows = (seg[1] << 8) | seg[2];
      cols = (seg[3] << 8) | seg[4];
      if (seg[5] != 1) return -2;  // multi-component
      have_sof = true;
    } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
               marker != 0xC8 && marker != 0xCC) {
      return -2;  // a SOF other than lossless
    } else if (marker == 0xC4) {
      int p = 0;
      while (p < seg_len) {
        int th = seg[p] & 0x0F;
        int cnt = 0;
        for (int i = 0; i < 16; ++i) cnt += seg[p + 1 + i];
        if (th > 3 || cnt > 64 || p + 17 + cnt > seg_len) return -1;
        for (int i = 0; i < 16; ++i) bits_count[th][i] = seg[p + 1 + i];
        nsym[th] = cnt;
        for (int i = 0; i < cnt; ++i) huffval[th][i] = seg[p + 17 + i];
        p += 17 + cnt;
      }
    } else if (marker == 0xDD) {
      return -2;  // restart intervals
    } else if (marker == 0xDA) {
      if (seg_len < 6 || seg[0] != 1) return -2;
      comp_table = seg[2] >> 4;
      sv = seg[3];
      pt = seg[5] & 0x0F;
      have_sos = true;
      entropy_start = pos + 2 + length;
      break;
    }
    pos += 2 + length;
  }
  if (!have_sof || !have_sos) return -1;
  if (comp_table < 0 || comp_table > 3 || nsym[comp_table] == 0) return -1;
  const int* bits_sel = bits_count[comp_table];
  const uint8_t* huff_sel = huffval[comp_table];
  int nsym_sel = nsym[comp_table];
  if (sv < 1 || sv > 7) return -2;
  if (P < 2 || P > 16 || pt > P - 1) return -1;   // shift UB on bad headers
  for (int i = 0; i < nsym_sel; ++i)
    if (huff_sel[i] > 16) return -1;              // SSSS categories are 0..16
  if ((int64_t)rows * cols > out_cap) return -3;
  *rows_out = rows;
  *cols_out = cols;

  // canonical decode tables per length: mincode/maxcode/valptr
  int32_t mincode[17], maxcode[17], valptr[17];
  {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits_sel[l - 1];
      k += bits_sel[l - 1];
      maxcode[l] = code - 1;  // -1 when no codes of this length
      if (bits_sel[l - 1] == 0) maxcode[l] = -1;
      code <<= 1;
    }
  }

  BitReader r{data, n, entropy_start, 0, 0, false, false, false};
  int32_t defaultv = 1 << (P - 1 - pt);
  for (int row = 0; row < rows; ++row) {
    for (int col = 0; col < cols; ++col) {
      // Huffman-decode the category
      int code = br_read(r, 1);
      int l = 1;
      while (l <= 16 && (maxcode[l] < 0 || code > maxcode[l])) {
        code = (code << 1) | br_read(r, 1);
        ++l;
      }
      if (l > 16 || r.err) return -1;
      int ssss = huff_sel[valptr[l] + code - mincode[l]];
      int32_t diff;
      if (ssss == 0) {
        diff = 0;
      } else if (ssss == 16) {
        diff = 32768;
      } else {
        uint32_t mag = br_read(r, ssss);
        diff = (mag >= (1u << (ssss - 1)))
                   ? (int32_t)mag
                   : (int32_t)mag - (1 << ssss) + 1;
      }
      int32_t px;
      if (row == 0) {
        px = (col == 0) ? defaultv : (int32_t)out[col - 1];
      } else if (col == 0) {
        px = (int32_t)out[(int64_t)(row - 1) * cols];
      } else {
        px = sof3_predict((int32_t)out[(int64_t)row * cols + col - 1],
                          (int32_t)out[(int64_t)(row - 1) * cols + col],
                          (int32_t)out[(int64_t)(row - 1) * cols + col - 1],
                          sv);
      }
      out[(int64_t)row * cols + col] = (uint16_t)((px + diff) & 0xFFFF);
    }
  }
  return r.err ? -1 : 0;
}

// --- JPEG-LS (T.87) --------------------------------------------------------

static const int kJlsJ[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  2,  2,  3,  3,
                              3, 3, 4, 4, 5, 5, 6, 6, 7, 7,  8,  9,  10, 11,
                              12, 13, 14, 15};

struct JlsState {
  int maxval, near, t1, t2, t3, reset;
  int range, qbpp, limit;
  int32_t A[367], B[365], C[365], N[367], Nn[2];
  int run_index;
};

static void jls_init(JlsState& s, int maxval, int near, int t1, int t2,
                     int t3, int reset) {
  s.maxval = maxval;
  s.near = near;
  s.t1 = t1;
  s.t2 = t2;
  s.t3 = t3;
  s.reset = reset;
  s.range = (maxval + 2 * near) / (2 * near + 1) + 1;
  s.qbpp = 0;
  while ((1 << s.qbpp) < s.range) s.qbpp++;
  int bpp = 2;
  while ((1 << bpp) < maxval + 1) bpp++;
  if (bpp < 2) bpp = 2;
  s.limit = 2 * (bpp + (bpp > 8 ? bpp : 8));
  int a_init = (s.range + 32) / 64;
  if (a_init < 2) a_init = 2;
  for (int i = 0; i < 367; ++i) {
    s.A[i] = a_init;
    s.N[i] = 1;
  }
  for (int i = 0; i < 365; ++i) s.B[i] = s.C[i] = 0;
  s.Nn[0] = s.Nn[1] = 0;
  s.run_index = 0;
}

static void jls_defaults(int maxval, int near, int* t1, int* t2, int* t3) {
  auto clampv = [&](int v, int lo) {
    if (v < lo) v = lo;
    if (v > maxval) v = maxval;
    return v;
  };
  if (maxval >= 128) {
    int factor = ((maxval < 4095 ? maxval : 4095) + 128) >> 8;
    *t1 = clampv(factor * (3 - 2) + 2 + 3 * near, near + 1);
    *t2 = clampv(factor * (7 - 3) + 3 + 5 * near, *t1);
    *t3 = clampv(factor * (21 - 4) + 4 + 7 * near, *t2);
  } else {
    // T.87 C.2.4.1.1.1 small-alphabet branch: FACTOR = 256/(MAXVAL+1),
    // Ti = max(floor_i, BASIC_Ti/FACTOR + k*NEAR)
    int factor = 256 / (maxval + 1);
    int v1 = 3 / factor + 3 * near;
    *t1 = clampv(v1 > 2 ? v1 : 2, near + 1);
    int v2 = 7 / factor + 5 * near;
    *t2 = clampv(v2 > 3 ? v2 : 3, *t1);
    int v3 = 21 / factor + 7 * near;
    *t3 = clampv(v3 > 4 ? v3 : 4, *t2);
  }
}

static inline int jls_quantize(const JlsState& s, int d) {
  if (d <= -s.t3) return -4;
  if (d <= -s.t2) return -3;
  if (d <= -s.t1) return -2;
  if (d < -s.near) return -1;
  if (d <= s.near) return 0;
  if (d < s.t1) return 1;
  if (d < s.t2) return 2;
  if (d < s.t3) return 3;
  return 4;
}

static inline int32_t jls_med(int32_t ra, int32_t rb, int32_t rc) {
  int32_t mx = ra > rb ? ra : rb, mn = ra < rb ? ra : rb;
  if (rc >= mx) return mn;
  if (rc <= mn) return mx;
  return ra + rb - rc;
}

static inline int32_t jls_golomb_read(BitReader& r, int k, int limit,
                                      int qbpp) {
  int high = br_unary(r, limit);
  if (high < limit - qbpp - 1)
    return ((int32_t)high << k) | (k ? (int32_t)br_read(r, k) : 0);
  return (int32_t)br_read(r, qbpp) + 1;
}

static inline int32_t jls_reconstruct(const JlsState& s, int32_t px,
                                      int32_t signed_err) {
  int32_t rec = px + signed_err * (2 * s.near + 1);
  if (rec < -s.near)
    rec += s.range * (2 * s.near + 1);
  else if (rec > s.maxval + s.near)
    rec -= s.range * (2 * s.near + 1);
  if (rec < 0) rec = 0;
  if (rec > s.maxval) rec = s.maxval;
  return rec;
}

// Decode a single-component JPEG-LS stream into out (row-major uint16).
int32_t jpegls_decode(const uint8_t* data, int64_t n, uint16_t* out,
                      int64_t out_cap, int32_t* rows_out,
                      int32_t* cols_out) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  int64_t pos = 2;
  int P = 0, rows = 0, cols = 0, near = 0;
  int maxval_override = 0, t1o = 0, t2o = 0, t3o = 0, reset = 64;
  bool have_sof = false;
  int64_t entropy_start = -1;

  while (pos + 4 <= n) {
    if (data[pos] != 0xFF) return -1;
    uint8_t marker = data[pos + 1];
    if (marker == 0xD9) break;
    int length = (data[pos + 2] << 8) | data[pos + 3];
    const uint8_t* seg = data + pos + 4;
    int seg_len = length - 2;
    if (pos + 2 + length > n) return -1;
    if (marker == 0xF7) {  // SOF55
      if (seg_len < 8) return -1;
      P = seg[0];
      rows = (seg[1] << 8) | seg[2];
      cols = (seg[3] << 8) | seg[4];
      if (seg[5] != 1) return -2;
      have_sof = true;
    } else if (marker == 0xF8) {  // LSE
      if (seg_len >= 11 && seg[0] == 1) {
        maxval_override = (seg[1] << 8) | seg[2];
        t1o = (seg[3] << 8) | seg[4];
        t2o = (seg[5] << 8) | seg[6];
        t3o = (seg[7] << 8) | seg[8];
        int rs = (seg[9] << 8) | seg[10];
        if (rs) reset = rs;
      }
    } else if (marker == 0xDA) {
      if (seg_len < 6 || seg[0] != 1) return -2;
      near = seg[3];
      if (seg[4] != 0) return -2;  // interleaved
      entropy_start = pos + 2 + length;
      break;
    }
    pos += 2 + length;
  }
  if (!have_sof || entropy_start < 0) return -1;
  if (P < 2 || P > 16) return -2;
  if ((int64_t)rows * cols > out_cap) return -3;
  *rows_out = rows;
  *cols_out = cols;

  int maxval = maxval_override ? maxval_override : (1 << P) - 1;
  int t1, t2, t3;
  if (t1o || t2o || t3o) {
    t1 = t1o;
    t2 = t2o;
    t3 = t3o;
  } else {
    jls_defaults(maxval, near, &t1, &t2, &t3);
  }
  JlsState s;
  jls_init(s, maxval, near, t1, t2, t3, reset);

  BitReader r{data, n, entropy_start, 0, 0, false, true, false};

  for (int row = 0; row < rows; ++row) {
    uint16_t* cur = out + (int64_t)row * cols;
    const uint16_t* prev = row ? out + (int64_t)(row - 1) * cols : nullptr;
    const uint16_t* prev2 = row >= 2 ? out + (int64_t)(row - 2) * cols
                                     : nullptr;
    int col = 0;
    while (col < cols) {
      if (r.err) return -1;
      int32_t rb = prev ? prev[col] : 0;
      int32_t rd = (col + 1 < cols) ? (prev ? prev[col + 1] : 0) : rb;
      int32_t ra, rc;
      if (col == 0) {
        ra = rb;
        rc = prev2 ? prev2[0] : 0;
      } else {
        ra = cur[col - 1];
        rc = prev ? prev[col - 1] : 0;
      }
      int q = 81 * jls_quantize(s, rd - rb) + 9 * jls_quantize(s, rb - rc) +
              jls_quantize(s, rc - ra);
      int sign = 1;
      if (q < 0) {
        q = -q;
        sign = -1;
      }
      if (q == 0) {
        // ---- run mode ----
        int32_t runval = ra;
        bool eol = false;
        for (;;) {
          if (br_read(r, 1) == 1) {
            int seg_len2 = 1 << kJlsJ[s.run_index];
            int fill = seg_len2 < cols - col ? seg_len2 : cols - col;
            for (int i = 0; i < fill; ++i) cur[col + i] = (uint16_t)runval;
            col += fill;
            if (fill == seg_len2 && s.run_index < 31) s.run_index++;
            if (col == cols) {
              eol = true;
              break;
            }
          } else {
            int jbits = kJlsJ[s.run_index];
            int cnt = jbits ? (int)br_read(r, jbits) : 0;
            // a '0' run segment is always followed by an interruption
            // sample, so the literal count must leave >=1 column free;
            // cnt == cols - col would put that sample one past the row
            // (out-of-bounds write on untrusted input)
            if (cnt > cols - col - 1) return -1;
            for (int i = 0; i < cnt; ++i) cur[col + i] = (uint16_t)runval;
            col += cnt;
            break;
          }
          if (r.err) return -1;
        }
        if (eol) continue;
        // run interruption sample
        rb = prev ? prev[col] : 0;
        ra = col ? cur[col - 1] : (prev ? prev[0] : 0);
        int ad = ra - rb;
        if (ad < 0) ad = -ad;
        int ritype = (ad <= s.near) ? 1 : 0;
        int32_t px = ritype ? ra : rb;
        int ri_sign = (!ritype && ra > rb) ? -1 : 1;
        int qq = 365 + ritype;
        int32_t temp_a = s.A[qq] + (ritype ? (s.N[qq] >> 1) : 0);
        int k = 0;
        while ((s.N[qq] << k) < temp_a) k++;
        int32_t emerrval = jls_golomb_read(
            r, k, s.limit - kJlsJ[s.run_index] - 1, s.qbpp);
        if (r.err) return -1;
        int32_t temp = emerrval + ritype;
        int emap = temp & 1;
        int32_t errvalabs = (temp + emap) / 2;
        int neg_pred = (k != 0 || 2 * s.Nn[ritype] >= s.N[qq]) ? 1 : 0;
        int32_t errval = (emap == neg_pred) ? -errvalabs : errvalabs;
        if (errval < 0) s.Nn[ritype]++;
        s.A[qq] += (emerrval + 1 - ritype) >> 1;
        if (s.N[qq] == s.reset) {
          s.A[qq] >>= 1;
          s.N[qq] >>= 1;
          s.Nn[ritype] >>= 1;
        }
        s.N[qq]++;
        if (s.run_index > 0) s.run_index--;
        cur[col] = (uint16_t)jls_reconstruct(s, px, ri_sign * errval);
        col++;
        continue;
      }
      // ---- regular mode ----
      int32_t px = jls_med(ra, rb, rc) + sign * s.C[q];
      if (px < 0) px = 0;
      if (px > s.maxval) px = s.maxval;
      int k = 0;
      while ((s.N[q] << k) < s.A[q]) k++;
      int32_t merrval = jls_golomb_read(r, k, s.limit, s.qbpp);
      if (r.err) return -1;
      int32_t errval;
      if (s.near == 0 && k == 0 && 2 * s.B[q] <= -s.N[q]) {
        errval = (merrval & 1) ? (merrval - 1) / 2 : -(merrval / 2) - 1;
      } else {
        errval = (merrval % 2 == 0) ? merrval / 2 : -((merrval + 1) / 2);
      }
      // update (A.6)
      s.B[q] += errval * (2 * s.near + 1);
      s.A[q] += errval < 0 ? -errval : errval;
      if (s.N[q] == s.reset) {
        s.A[q] >>= 1;
        s.B[q] = s.B[q] >= 0 ? (s.B[q] >> 1) : -((1 - s.B[q]) >> 1);
        s.N[q] >>= 1;
      }
      s.N[q]++;
      if (s.B[q] <= -s.N[q]) {
        s.B[q] += s.N[q];
        if (s.C[q] > -128) s.C[q]--;
        if (s.B[q] <= -s.N[q]) s.B[q] = -s.N[q] + 1;
      } else if (s.B[q] > 0) {
        s.B[q] -= s.N[q];
        if (s.C[q] < 127) s.C[q]++;
        if (s.B[q] > 0) s.B[q] = 0;
      }
      cur[col] = (uint16_t)jls_reconstruct(s, px, sign * errval);
      col++;
    }
  }
  return r.err ? -1 : 0;
}

// ---------------------------------------------------------------------------
// Bit-field unpack for the deploy engines' label readback.
// ---------------------------------------------------------------------------

// Unpack `bits`-wide fields (bits in {1,2,4}) from n_bytes packed bytes
// into n uint8 values, low field first — the exact inverse of the
// device-side pack (infer/engine.py).  The numpy unpack materialised a
// (n_bytes, 8/bits) temporary plus two reshape/astype copies per cine;
// this writes the output buffer once via a 256-entry per-byte table.
void unpack_bits(const uint8_t* in, int64_t n_bytes, int32_t bits,
                 uint8_t* out, int64_t n) {
  const int32_t per = 8 / bits;
  const uint8_t mask = (uint8_t)((1u << bits) - 1u);
  // per-byte lookup: byte -> up to 8 unpacked values
  uint8_t table[256][8];
  for (int v = 0; v < 256; ++v)
    for (int32_t j = 0; j < per; ++j)
      table[v][j] = (uint8_t)((v >> (bits * j)) & mask);
  const int64_t full = n / per;  // bytes whose every field is in range
  for (int64_t i = 0; i < full; ++i)
    std::memcpy(out + i * per, table[in[i]], (size_t)per);
  for (int64_t o = full * per; o < n; ++o)
    out[o] = table[in[o / per]][o % per];
}

}  // extern "C"
