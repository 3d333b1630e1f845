// nrcio: the VDB decoder of the nrc_hpm_tpu_torch port, host C++.
//
// A copy of the JAX package's native/nrcio.cpp decoder, so the port reads
// nothing of that package: a dependency-free OpenVDB Tree_float_5_4_3
// dense decoder (file versions 220-224, no blosc) behind the C ABI
// nrcio_vdb_load / nrcio_last_error / nrcio_free, loaded with ctypes by
// nrc_hpm_tpu_torch/utils/native.py, which builds it at first use:
//
//   g++ -O2 -fPIC -std=c++17 -shared -o libnrcio-<hash>.so nrcio.cpp \
//       -l:libz.so.1
//
// The one zlib entry point it calls is declared below, so the build needs
// only zlib's runtime library, not its headers.  The numpy parser in
// utils/vdb.py is the oracle it is tested against, bitwise.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

// zlib's uncompress (zlib.h): Z_OK is 0
extern "C" int uncompress(unsigned char* dest, unsigned long* dest_len,
                          const unsigned char* source,
                          unsigned long source_len);

namespace {

// ---------------------------------------------------------------------------
// small binary reader
// ---------------------------------------------------------------------------
struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  bool need(size_t k) {
    if (off + k > n) { ok = false; return false; }
    return true;
  }
  template <typename T> T get() {
    T v{};
    if (need(sizeof(T))) { memcpy(&v, p + off, sizeof(T)); off += sizeof(T); }
    return v;
  }
  std::string getString() {
    uint32_t len = get<uint32_t>();
    if (!need(len)) return "";
    std::string s(reinterpret_cast<const char*>(p + off), len);
    off += len;
    return s;
  }
  void skip(size_t k) { need(k) && (off += k, true); }
};

static char g_error[512] = {0};
void set_error(const char* msg) {
  snprintf(g_error, sizeof(g_error), "%s", msg);
}

// ---------------------------------------------------------------------------
// OpenVDB Tree_float_5_4_3 reader (mirrors utils/vdb.py)
// ---------------------------------------------------------------------------
constexpr uint32_t COMPRESS_ZIP = 0x1;
constexpr uint32_t COMPRESS_ACTIVE_MASK = 0x2;
constexpr uint32_t COMPRESS_BLOSC = 0x4;

struct VdbCtx {
  Reader r;
  uint32_t version = 0;
  uint32_t compression = 0;
  bool half = false;
  // grid metadata we care about
  int32_t bbox_min[3] = {0, 0, 0};
  int32_t bbox_max[3] = {-1, -1, -1};
  bool have_bbox = false;
  double voxel_size = 1.0;
  // dense output
  std::vector<float> dense;
  int64_t ext[3] = {0, 0, 0};
  // deferred leaves: (origin xyz), masks read again in buffer pass
  struct Leaf { int32_t o[3]; };
  std::vector<Leaf> leaves;
  // filled boxes from active tiles
  struct Tile { int32_t o[3]; int32_t edge; float value; };
  std::vector<Tile> tiles;
};

bool read_metadata(VdbCtx& c, bool grid_level) {
  uint32_t count = c.r.get<uint32_t>();
  for (uint32_t i = 0; i < count && c.r.ok; i++) {
    std::string name = c.r.getString();
    std::string type = c.r.getString();
    uint32_t size = c.r.get<uint32_t>();
    if (!c.r.need(size)) return false;
    const uint8_t* val = c.r.p + c.r.off;
    if (grid_level && type == "vec3i" && size == 12) {
      int32_t v[3];
      memcpy(v, val, 12);
      if (name == "file_bbox_min") { memcpy(c.bbox_min, v, 12); }
      if (name == "file_bbox_max") { memcpy(c.bbox_max, v, 12); c.have_bbox = true; }
    }
    if (grid_level && name == "is_saved_as_half_float" && size == 1)
      c.half = val[0] != 0;
    c.r.off += size;
  }
  return c.r.ok;
}

// number of serialized doubles per transform map type
int map_doubles(const std::string& t) {
  if (t == "UniformScaleMap" || t == "ScaleMap") return 15;
  if (t == "UniformScaleTranslateMap" || t == "ScaleTranslateMap") return 18;
  if (t == "TranslationMap") return 3;
  if (t == "UnitaryMap" || t == "AffineMap") return 16;
  return -1;
}

// read `count` raw values applying zip if flagged
bool read_values(VdbCtx& c, size_t count, std::vector<float>& out) {
  out.resize(count);
  size_t itemsz = c.half ? 2 : 4;
  std::vector<uint8_t> buf;
  const uint8_t* src;
  if (c.compression & COMPRESS_ZIP) {
    int64_t nbytes = c.r.get<int64_t>();
    if (nbytes <= 0) {
      if (!c.r.need(-nbytes)) return false;
      src = c.r.p + c.r.off;
      c.r.off += -nbytes;
    } else {
      if (!c.r.need(nbytes)) return false;
      buf.resize(count * itemsz);
      unsigned long dlen = buf.size();
      if (uncompress(buf.data(), &dlen, c.r.p + c.r.off, nbytes) != 0) {
        set_error("zlib inflate failed");
        return false;
      }
      c.r.off += nbytes;
      src = buf.data();
    }
  } else {
    if (!c.r.need(count * itemsz)) return false;
    src = c.r.p + c.r.off;
    c.r.off += count * itemsz;
  }
  if (c.half) {
    for (size_t i = 0; i < count; i++) {
      uint16_t h;
      memcpy(&h, src + 2 * i, 2);
      // half -> float
      uint32_t sign = (h >> 15) & 1, exp = (h >> 10) & 0x1F, man = h & 0x3FF;
      uint32_t f;
      if (exp == 0) {
        if (man == 0) f = sign << 31;
        else {
          exp = 127 - 15 + 1;
          while (!(man & 0x400)) { man <<= 1; exp--; }
          man &= 0x3FF;
          f = (sign << 31) | (exp << 23) | (man << 13);
        }
      } else if (exp == 31) {
        f = (sign << 31) | 0x7F800000 | (man << 13);
      } else {
        f = (sign << 31) | ((exp - 15 + 127) << 23) | (man << 13);
      }
      memcpy(&out[i], &f, 4);
    }
  } else {
    memcpy(out.data(), src, count * 4);
  }
  return true;
}

// io::readCompressedValues
bool read_compressed_values(VdbCtx& c, size_t count,
                            const std::vector<uint8_t>& value_mask,
                            std::vector<float>& out) {
  int8_t meta = 6;  // NO_MASK_AND_ALL_VALS
  if (c.version >= 222) meta = c.r.get<int8_t>();
  float inactive0 = 0, inactive1 = 0;
  if (meta == 2 || meta == 4 || meta == 5) {
    inactive0 = c.r.get<float>();
    if (meta == 5) inactive1 = c.r.get<float>();
  }
  std::vector<uint8_t> selection;
  if (meta == 3 || meta == 4 || meta == 5) {
    selection.resize(count / 8);
    if (!c.r.need(selection.size())) return false;
    memcpy(selection.data(), c.r.p + c.r.off, selection.size());
    c.r.off += selection.size();
  }
  bool mask_compressed =
      (c.compression & COMPRESS_ACTIVE_MASK) && meta != 6 && c.version >= 222;
  size_t n_stored = count;
  if (mask_compressed) {
    n_stored = 0;
    for (size_t i = 0; i < count; i++)
      n_stored += (value_mask[i >> 3] >> (i & 7)) & 1;
  }
  std::vector<float> stored;
  if (!read_values(c, n_stored, stored)) return false;

  out.assign(count, 0.0f);
  if (mask_compressed) {
    size_t k = 0;
    for (size_t i = 0; i < count; i++) {
      bool on = (value_mask[i >> 3] >> (i & 7)) & 1;
      if (on) out[i] = stored[k++];
      else if (inactive0 != 0 || inactive1 != 0) {
        bool sel = !selection.empty() && ((selection[i >> 3] >> (i & 7)) & 1);
        out[i] = sel ? inactive1 : inactive0;
      }
    }
  } else {
    for (size_t i = 0; i < count; i++) out[i] = stored[i];
  }
  return true;
}

bool load_mask(VdbCtx& c, int log2dim, std::vector<uint8_t>& mask) {
  size_t nbytes = (size_t(1) << (3 * log2dim)) / 8;
  mask.resize(nbytes);
  if (!c.r.need(nbytes)) return false;
  memcpy(mask.data(), c.r.p + c.r.off, nbytes);
  c.r.off += nbytes;
  return true;
}

bool read_internal_topology(VdbCtx& c, const int32_t origin[3], int log2dim,
                            int child_tot_log2) {
  std::vector<uint8_t> child_mask, value_mask;
  if (!load_mask(c, log2dim, child_mask)) return false;
  if (!load_mask(c, log2dim, value_mask)) return false;
  size_t n_values = size_t(1) << (3 * log2dim);
  std::vector<float> values;
  if (!read_compressed_values(c, n_values, value_mask, values)) return false;

  int32_t child_dim = 1 << child_tot_log2;
  int dim_mask = (1 << log2dim) - 1;
  for (size_t nidx = 0; nidx < n_values; nidx++) {
    bool has_child = (child_mask[nidx >> 3] >> (nidx & 7)) & 1;
    bool value_on = (value_mask[nidx >> 3] >> (nidx & 7)) & 1;
    int32_t ox = (nidx >> (2 * log2dim)) & dim_mask;
    int32_t oy = (nidx >> log2dim) & dim_mask;
    int32_t oz = nidx & dim_mask;
    int32_t corigin[3] = {origin[0] + ox * child_dim,
                          origin[1] + oy * child_dim,
                          origin[2] + oz * child_dim};
    if (value_on && !has_child)
      c.tiles.push_back({{corigin[0], corigin[1], corigin[2]}, child_dim,
                         values[nidx]});
    if (has_child) {
      if (child_tot_log2 == 3) {
        std::vector<uint8_t> leaf_mask;
        if (!load_mask(c, 3, leaf_mask)) return false;
        c.leaves.push_back({{corigin[0], corigin[1], corigin[2]}});
      } else {
        if (!read_internal_topology(c, corigin, 4, 3)) return false;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

const char* nrcio_last_error() { return g_error; }

void nrcio_free(void* p) { free(p); }

// Load the first Tree_float_5_4_3 grid of a .vdb as a dense [X,Y,Z] float
// array over its file_bbox.  Returns 0 on success.
int nrcio_vdb_load(const char* path, float** out_data, int64_t dims[3],
                   int32_t bbox_min[3], double* voxel_size) {
  g_error[0] = 0;
  FILE* f = fopen(path, "rb");
  if (!f) { set_error("cannot open file"); return 1; }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (fread(data.data(), 1, size, f) != size_t(size)) {
    fclose(f);
    set_error("short read");
    return 1;
  }
  fclose(f);

  VdbCtx c;
  c.r = {data.data(), data.size()};
  int64_t magic = c.r.get<int64_t>();
  if (magic != 0x56444220) { set_error("not an OpenVDB file"); return 1; }
  c.version = c.r.get<uint32_t>();
  if (c.version < 220 || c.version > 224) {
    set_error("unsupported VDB file version");
    return 1;
  }
  c.r.get<uint32_t>();  // lib major
  c.r.get<uint32_t>();  // lib minor
  uint8_t has_offsets = c.r.get<uint8_t>();
  if (!has_offsets) { set_error("no grid offsets"); return 1; }
  c.r.skip(36);  // uuid
  if (c.version >= 224) {
    uint32_t comp = c.r.get<uint32_t>();
    if (comp & COMPRESS_BLOSC) { set_error("blosc unsupported"); return 1; }
  }
  if (!read_metadata(c, false)) { set_error("bad file metadata"); return 1; }
  uint32_t grid_count = c.r.get<uint32_t>();
  int64_t grid_pos = -1;
  for (uint32_t g = 0; g < grid_count; g++) {
    std::string name = c.r.getString();
    std::string type = c.r.getString();
    if (c.version >= 214) c.r.getString();  // instance parent
    int64_t gpos = c.r.get<int64_t>();
    c.r.get<int64_t>();  // block pos
    c.r.get<int64_t>();  // end pos
    if (grid_pos < 0 && type == "Tree_float_5_4_3") grid_pos = gpos;
  }
  if (grid_pos < 0) { set_error("no Tree_float_5_4_3 grid"); return 1; }

  c.r.off = size_t(grid_pos);
  if (c.version >= 222) c.compression = c.r.get<uint32_t>();
  if (c.compression & COMPRESS_BLOSC) { set_error("blosc unsupported"); return 1; }
  if (!read_metadata(c, true)) { set_error("bad grid metadata"); return 1; }
  std::string map_type = c.r.getString();
  int nd = map_doubles(map_type);
  if (nd < 0) { set_error("unsupported transform map"); return 1; }
  std::vector<double> doubles(nd);
  for (int i = 0; i < nd; i++) doubles[i] = c.r.get<double>();
  c.voxel_size = (map_type.find("Scale") != std::string::npos && nd >= 6)
                     ? doubles[3] : 1.0;

  // topology
  uint32_t buffer_count = c.r.get<uint32_t>();
  if (buffer_count != 1) { set_error("multi-buffer tree"); return 1; }
  c.r.get<float>();  // background
  uint32_t num_tiles = c.r.get<uint32_t>();
  uint32_t num_children = c.r.get<uint32_t>();
  for (uint32_t i = 0; i < num_tiles; i++) {
    int32_t o[3] = {c.r.get<int32_t>(), c.r.get<int32_t>(),
                    c.r.get<int32_t>()};
    float v = c.r.get<float>();
    uint8_t active = c.r.get<uint8_t>();
    if (active) c.tiles.push_back({{o[0], o[1], o[2]}, 1 << 12, v});
  }
  for (uint32_t i = 0; i < num_children && c.r.ok; i++) {
    int32_t o[3] = {c.r.get<int32_t>(), c.r.get<int32_t>(),
                    c.r.get<int32_t>()};
    if (!read_internal_topology(c, o, 5, 7)) {
      if (!g_error[0]) set_error("bad topology");
      return 1;
    }
  }
  if (!c.r.ok) { set_error("truncated topology"); return 1; }
  if (!c.have_bbox) { set_error("missing file_bbox metadata"); return 1; }

  // dense buffer
  for (int i = 0; i < 3; i++) {
    c.ext[i] = int64_t(c.bbox_max[i]) - c.bbox_min[i] + 1;
    if (c.ext[i] <= 0) { set_error("bad bbox"); return 1; }
  }
  size_t total = size_t(c.ext[0]) * c.ext[1] * c.ext[2];
  float* dense = static_cast<float*>(calloc(total, sizeof(float)));
  if (!dense) { set_error("alloc failed"); return 1; }

  auto fill_box = [&](const int32_t o[3], int32_t edge, float v) {
    int64_t lo[3], hi[3];
    for (int i = 0; i < 3; i++) {
      lo[i] = std::max<int64_t>(o[i] - c.bbox_min[i], 0);
      hi[i] = std::min<int64_t>(int64_t(o[i]) + edge - c.bbox_min[i],
                                c.ext[i]);
      if (hi[i] <= lo[i]) return;
    }
    for (int64_t x = lo[0]; x < hi[0]; x++)
      for (int64_t y = lo[1]; y < hi[1]; y++) {
        float* row = dense + (x * c.ext[1] + y) * c.ext[2];
        for (int64_t z = lo[2]; z < hi[2]; z++) row[z] = v;
      }
  };
  for (auto& t : c.tiles) fill_box(t.o, t.edge, t.value);

  // buffer pass: leaves in the same depth-first order
  for (auto& leaf : c.leaves) {
    std::vector<uint8_t> mask;
    if (!load_mask(c, 3, mask)) { free(dense); set_error("bad leaf"); return 1; }
    if (c.version < 222) c.r.skip(13);  // origin + numBuffers
    std::vector<float> vals;
    if (!read_compressed_values(c, 512, mask, vals)) {
      free(dense);
      if (!g_error[0]) set_error("bad leaf buffer");
      return 1;
    }
    for (int i = 0; i < 512; i++) {
      bool on = (mask[i >> 3] >> (i & 7)) & 1;
      if (!on) continue;
      int64_t x = leaf.o[0] + (i >> 6) - c.bbox_min[0];
      int64_t y = leaf.o[1] + ((i >> 3) & 7) - c.bbox_min[1];
      int64_t z = leaf.o[2] + (i & 7) - c.bbox_min[2];
      if (x < 0 || y < 0 || z < 0 || x >= c.ext[0] || y >= c.ext[1] ||
          z >= c.ext[2])
        continue;
      dense[(x * c.ext[1] + y) * c.ext[2] + z] = vals[i];
    }
  }

  *out_data = dense;
  for (int i = 0; i < 3; i++) {
    dims[i] = c.ext[i];
    bbox_min[i] = c.bbox_min[i];
  }
  if (voxel_size) *voxel_size = c.voxel_size;
  return 0;
}

}  // extern "C"
