// Native host runtime: OBJ parsing + BVH build + skip-list flattening.
//
// The reference does this work in JavaScript (modules/scene.js:62-154
// generateBVH, :190-316 flattener, :330-436 OBJ importer); at dragon scale
// (43.6k faces) the Python object-per-triangle path costs tens of seconds.
// This C++ path parses the OBJ, builds the same least-straddle median-split
// BVH (<=4 leaves per node, min half-width 1/256, +-2^-16-ish bias) over
// per-triangle AABBs, and emits the flattened skip-pointer stream directly.
//
// C ABI for ctypes. All buffers are allocated here and freed by
// fl_release(); the Python side copies out what it needs.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr double kBias = 0.00152587890625;     // scene.js:159
constexpr double kMinWidth = 1.0 / 256.0;       // scene.js:140
constexpr int kMaxLeaves = 4;                   // scene.js:6

struct Vec3 { double x, y, z; };

struct Tri {
  float v[9];    // 3 vertices
  float n[9];    // 3 normals
  float t[6];    // 3 uvs
  int32_t mat;   // material index (-1 none)
};

struct LoadResult {
  std::vector<Tri> tris;
  std::vector<std::string> materials;  // distinct usemtl names in order
  // Flattened skip-list stream:
  //   kind[i]: 1 = BVH node (aabb[i*6..], skip[i]), 2 = triangle (tri_index[i])
  std::vector<int32_t> kind;
  std::vector<float> aabb;      // [slots, 6] (only meaningful for nodes)
  std::vector<int32_t> skip;
  std::vector<int32_t> tri_index;
};

double parse_num(const char*& p) {
  char* end;
  double v = strtod(p, &end);
  p = end;
  return v;
}

// --- OBJ parsing (scene.js:342-424 semantics) ---
void parse_obj(const char* text, size_t len, LoadResult& out) {
  std::vector<float> vs, vts, vns;
  int cur_mat = -1;
  const char* p = text;
  const char* end = text + len;
  while (p < end) {
    // start of line
    while (p < end && (*p == ' ' || *p == '\t')) p++;
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    if (p[0] == 'v' && p[1] == ' ') {
      const char* q = p + 2;
      float a = (float)parse_num(q), b = (float)parse_num(q), c = (float)parse_num(q);
      vs.push_back(a); vs.push_back(b); vs.push_back(c);
    } else if (p[0] == 'v' && p[1] == 't') {
      const char* q = p + 3;
      float a = (float)parse_num(q), b = (float)parse_num(q);
      vts.push_back(a); vts.push_back(b);
    } else if (p[0] == 'v' && p[1] == 'n') {
      const char* q = p + 3;
      float a = (float)parse_num(q), b = (float)parse_num(q), c = (float)parse_num(q);
      vns.push_back(a); vns.push_back(b); vns.push_back(c);
    } else if (p[0] == 'f' && p[1] == ' ') {
      // collect up to 4 vertex index triplets (v/vt/vn; negatives relative)
      int vi[4] = {0, 0, 0, 0}, ti[4] = {0, 0, 0, 0}, ni[4] = {0, 0, 0, 0};
      int count = 0;
      const char* q = p + 2;
      while (q < line_end && count < 4) {
        while (q < line_end && *q == ' ') q++;
        if (q >= line_end || !(*q == '-' || isdigit((unsigned char)*q))) break;
        long a = strtol(q, (char**)&q, 10);
        long b = 0, c = 0;
        if (*q == '/') {
          q++;
          if (*q != '/') b = strtol(q, (char**)&q, 10);
          if (*q == '/') { q++; c = strtol(q, (char**)&q, 10); }
        }
        if (a < 0) a = (long)(vs.size() / 3) + a + 1;
        if (b < 0) b = (long)(vts.size() / 2) + b + 1;
        if (c < 0) c = (long)(vns.size() / 3) + c + 1;
        vi[count] = (int)a; ti[count] = (int)b; ni[count] = (int)c;
        count++;
      }
      auto emit = [&](int i0, int i1, int i2, const int order_t[3]) {
        Tri tri;
        int idx[3] = {i0, i1, i2};
        // flat normal from cross(a-c, a-b), normalized (scene.js:755)
        const float* a = &vs[(vi[idx[0]] - 1) * 3];
        const float* b = &vs[(vi[idx[1]] - 1) * 3];
        const float* c = &vs[(vi[idx[2]] - 1) * 3];
        double e1x = a[0] - c[0], e1y = a[1] - c[1], e1z = a[2] - c[2];
        double e2x = a[0] - b[0], e2y = a[1] - b[1], e2z = a[2] - b[2];
        double nx = e1y * e2z - e1z * e2y;
        double ny = e1z * e2x - e1x * e2z;
        double nz = e1x * e2y - e1y * e2x;
        double nl = std::sqrt(nx * nx + ny * ny + nz * nz);
        if (nl < 1e-30) nl = 1.0;
        for (int k = 0; k < 3; k++) {
          const float* vv = &vs[(vi[idx[k]] - 1) * 3];
          tri.v[k * 3 + 0] = vv[0];
          tri.v[k * 3 + 1] = vv[1];
          tri.v[k * 3 + 2] = vv[2];
          // default flat normal; override with vn if present
          tri.n[k * 3 + 0] = (float)(nx / nl);
          tri.n[k * 3 + 1] = (float)(ny / nl);
          tri.n[k * 3 + 2] = (float)(nz / nl);
          if (ni[idx[k]] > 0) {
            const float* nn = &vns[(ni[idx[k]] - 1) * 3];
            tri.n[k * 3 + 0] = nn[0];
            tri.n[k * 3 + 1] = nn[1];
            tri.n[k * 3 + 2] = nn[2];
          }
          // default uv pattern ids: 0=(0,0) 1=(0,1) 2=(1,1) 3=(1,0)
          // (triangle default [0,0,0,1,1,1] scene.js:755; plane second tri
          // [1,1,1,0,0,0] scene.js:749)
          static const float kUvX[4] = {0.f, 0.f, 1.f, 1.f};
          static const float kUvY[4] = {0.f, 1.f, 1.f, 0.f};
          tri.t[k * 2 + 0] = kUvX[order_t[k]];
          tri.t[k * 2 + 1] = kUvY[order_t[k]];
          if (ti[idx[k]] > 0) {
            const float* tt = &vts[(ti[idx[k]] - 1) * 2];
            tri.t[k * 2 + 0] = tt[0];
            tri.t[k * 2 + 1] = tt[1];
          }
        }
        tri.mat = cur_mat;
        out.tris.push_back(tri);
      };
      if (count == 4) {
        // Plane: [c0,c1,c2] + [c2,c3,c0] with data reversed (scene.js:374-386):
        // c0..c3 = data[3],data[2],data[1],data[0]
        // first tri uses uv pattern (0,0),(0,1),(1,1); second (1,1),(1,0),(0,0)
        static const int uv_a[3] = {0, 1, 2};
        static const int uv_b[3] = {2, 3, 0};
        emit(3, 2, 1, uv_a);
        emit(1, 0, 3, uv_b);
      } else if (count == 3) {
        static const int uv_t[3] = {0, 1, 2};
        emit(2, 1, 0, uv_t);
      }
    } else if (!strncmp(p, "usemtl", 6)) {
      const char* q = p + 6;
      while (q < line_end && isspace((unsigned char)*q)) q++;
      std::string name(q, line_end - q);
      while (!name.empty() && isspace((unsigned char)name.back())) name.pop_back();
      cur_mat = -1;
      for (size_t i = 0; i < out.materials.size(); i++)
        if (out.materials[i] == name) { cur_mat = (int)i; break; }
      if (cur_mat < 0) {
        out.materials.push_back(name);
        cur_mat = (int)out.materials.size() - 1;
      }
    }
    p = line_end + 1;
  }
}

// --- BVH build over triangle AABBs (scene.js:62-154 policy) ---
struct Box { double lo[3], hi[3]; };

Box tri_box(const Tri& t) {
  Box b;
  for (int a = 0; a < 3; a++) {
    b.lo[a] = b.hi[a] = t.v[a];
    for (int k = 1; k < 3; k++) {
      b.lo[a] = std::min(b.lo[a], (double)t.v[k * 3 + a]);
      b.hi[a] = std::max(b.hi[a], (double)t.v[k * 3 + a]);
    }
  }
  return b;
}

Box combine_biased(const std::vector<Box>& boxes, const std::vector<int32_t>& ids) {
  // First child unbiased, later children +-bias (scene.js:166-172)
  Box out = boxes[ids[0]];
  for (size_t i = 1; i < ids.size(); i++) {
    const Box& b = boxes[ids[i]];
    for (int a = 0; a < 3; a++) {
      out.lo[a] = std::min(out.lo[a], b.lo[a] - kBias);
      out.hi[a] = std::max(out.hi[a], b.hi[a] + kBias);
    }
  }
  return out;
}

void divide(const std::vector<Box>& boxes, std::vector<int32_t>& ids,
            const Box& bound, int depth, double max_depth, LoadResult& out) {
  if ((int)ids.size() <= kMaxLeaves || depth > max_depth) {
    for (int32_t id : ids) {
      out.kind.push_back(2);
      for (int a = 0; a < 6; a++) out.aabb.push_back(0.f);
      out.skip.push_back(0);
      out.tri_index.push_back(id);
    }
    return;
  }
  double center[3] = {(bound.lo[0] + bound.hi[0]) / 2,
                      (bound.lo[1] + bound.hi[1]) / 2,
                      (bound.lo[2] + bound.hi[2]) / 2};
  int ideal = -1;
  long least = -1;
  for (int a = 0; a < 3; a++) {
    double min_diff = std::min(bound.hi[a] - center[a], center[a] - bound.lo[a]);
    long on_edge = 0;
    for (int32_t id : ids) {
      bool fits_hi = boxes[id].lo[a] >= center[a];
      bool fits_lo = boxes[id].hi[a] <= center[a];
      if (!fits_hi && !fits_lo) on_edge++;
    }
    if ((least < 0 || least >= on_edge) && min_diff > kMinWidth) {
      ideal = a;
      least = on_edge;
    }
  }
  if (ideal < 0) {  // OPTIMIZATION failed (scene.js:106-110): emit leaves
    for (int32_t id : ids) {
      out.kind.push_back(2);
      for (int a = 0; a < 6; a++) out.aabb.push_back(0.f);
      out.skip.push_back(0);
      out.tri_index.push_back(id);
    }
    return;
  }
  std::vector<int32_t> bucket[3];
  for (int32_t id : ids) {
    if (boxes[id].lo[ideal] >= center[ideal]) bucket[0].push_back(id);
    else if (boxes[id].hi[ideal] <= center[ideal]) bucket[1].push_back(id);
    else bucket[2].push_back(id);
  }
  ids.clear();
  ids.shrink_to_fit();
  for (int b = 0; b < 3; b++) {
    if (bucket[b].empty()) continue;
    Box bb = combine_biased(boxes, bucket[b]);
    // Reserve a node slot, recurse, backpatch AABB+skip (scene.js:239-259)
    size_t node_pos = out.kind.size();
    out.kind.push_back(1);
    for (int a = 0; a < 3; a++) out.aabb.push_back((float)bb.lo[a]);
    for (int a = 0; a < 3; a++) out.aabb.push_back((float)bb.hi[a]);
    out.skip.push_back(0);
    out.tri_index.push_back(-1);
    divide(boxes, bucket[b], bb, depth + 1, max_depth, out);
    out.skip[node_pos] = (int32_t)(out.kind.size() - node_pos - 1);
  }
}

void build_bvh(LoadResult& out) {
  size_t n = out.tris.size();
  std::vector<Box> boxes(n);
  std::vector<int32_t> ids(n);
  for (size_t i = 0; i < n; i++) {
    boxes[i] = tri_box(out.tris[i]);
    ids[i] = (int32_t)i;
  }
  if (n == 0) return;
  Box top = combine_biased(boxes, ids);
  double max_depth = std::log2((double)n) + 8.0;  // scene.js:149
  divide(boxes, ids, top, 0, max_depth, out);
}

}  // namespace

extern "C" {

struct FlHandle {
  LoadResult result;
  std::string mat_names;  // '\n'-joined
};

// Loads an OBJ and builds the flattened BVH stream. Returns handle or null.
FlHandle* fl_load_obj(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string text(size, '\0');
  if (fread(&text[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  FlHandle* h = new FlHandle();
  parse_obj(text.data(), text.size(), h->result);
  build_bvh(h->result);
  for (size_t i = 0; i < h->result.materials.size(); i++) {
    if (i) h->mat_names += '\n';
    h->mat_names += h->result.materials[i];
  }
  return h;
}

int64_t fl_num_tris(FlHandle* h) { return (int64_t)h->result.tris.size(); }
int64_t fl_num_slots(FlHandle* h) { return (int64_t)h->result.kind.size(); }
const char* fl_material_names(FlHandle* h) { return h->mat_names.c_str(); }

// Copy out triangle data: verts [T,9], normals [T,9], uvs [T,6], mat [T]
void fl_copy_tris(FlHandle* h, float* verts, float* normals, float* uvs,
                  int32_t* mats) {
  const auto& tris = h->result.tris;
  for (size_t i = 0; i < tris.size(); i++) {
    memcpy(verts + i * 9, tris[i].v, 9 * sizeof(float));
    memcpy(normals + i * 9, tris[i].n, 9 * sizeof(float));
    memcpy(uvs + i * 6, tris[i].t, 6 * sizeof(float));
    mats[i] = tris[i].mat;
  }
}

// Copy out the flattened stream: kind [S], aabb [S,6], skip [S], tri [S]
void fl_copy_stream(FlHandle* h, int32_t* kind, float* aabb, int32_t* skip,
                    int32_t* tri_index) {
  const auto& r = h->result;
  memcpy(kind, r.kind.data(), r.kind.size() * sizeof(int32_t));
  memcpy(aabb, r.aabb.data(), r.aabb.size() * sizeof(float));
  memcpy(skip, r.skip.data(), r.skip.size() * sizeof(int32_t));
  memcpy(tri_index, r.tri_index.data(), r.tri_index.size() * sizeof(int32_t));
}

void fl_release(FlHandle* h) { delete h; }

}  // extern "C"
