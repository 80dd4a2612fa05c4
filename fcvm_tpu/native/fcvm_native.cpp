// fcvm_native: mesh ingest + graph preprocessing for fcvm_tpu.
//
// Native replacement for the reference's C++ host layer (FreeCAD/SMESH mesh
// queries, source code/fcVM.py:122-347): tet10 mesh parsers (Gmsh ASCII
// v2.2/v4.1, UNV 2411/2412), reverse-Cuthill-McKee bandwidth reduction (node
// locality for the device-side windowed gather/scatter kernels), and adjacency
// counts.  Exposed through a plain C ABI consumed via ctypes; the Python
// side falls back to pure-numpy implementations when this library is not
// built.
//
// Build: make -C fcvm_tpu/native   (produces libfcvm_native.so)

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <fstream>
#include <queue>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct MeshData {
  int64_t nn = 0;
  int64_t ne = 0;
  std::vector<double> coords;    // nn * 3
  std::vector<int64_t> elnodes;  // ne * 10, 0-based, fcvm tet10 order
};

// fcvm tet10 midside order: (0-1),(1-2),(0-2),(0-3),(1-3),(2-3).
// Gmsh tet10 midside order: (0-1),(1-2),(0-2),(0-3),(2-3),(1-3)
// -> swap the last two midside slots.
constexpr int kGmshToFcvm[10] = {0, 1, 2, 3, 4, 5, 6, 7, 9, 8};

// UNV FE descriptor 118 (solid parabolic tetrahedron), SDRC node order:
// corner1, mid(1-2), corner2, mid(2-3), corner3, mid(3-1),
// mid(1-4), mid(2-4), mid(3-4), corner4.
// fcvm order: c1 c2 c3 c4, (c1-c2),(c2-c3),(c1-c3),(c1-c4),(c2-c4),(c3-c4).
constexpr int kUnvToFcvm[10] = {0, 4, 1, 5, 2, 6, 7, 8, 9, 3};
// kUnvToFcvm[i] gives the fcvm slot receiving UNV slot i:
//   unv0=c1->0, unv1=m12->4, unv2=c2->1, unv3=m23->5, unv4=c3->2,
//   unv5=m31->6, unv6=m14->7, unv7=m24->8, unv8=m34->9, unv9=c4->3

bool starts_with(const std::string& s, const char* p) {
  return s.rfind(p, 0) == 0;
}

}  // namespace

extern "C" {

struct FcvmMesh {
  int64_t nn;
  int64_t ne;
  double* coords;
  int64_t* elnodes;
};

static FcvmMesh* wrap(MeshData&& m) {
  auto* out = new FcvmMesh;
  out->nn = m.nn;
  out->ne = m.ne;
  out->coords = static_cast<double*>(malloc(sizeof(double) * m.nn * 3));
  out->elnodes = static_cast<int64_t*>(malloc(sizeof(int64_t) * m.ne * 10));
  memcpy(out->coords, m.coords.data(), sizeof(double) * m.nn * 3);
  memcpy(out->elnodes, m.elnodes.data(), sizeof(int64_t) * m.ne * 10);
  return out;
}

void fcvm_mesh_free(FcvmMesh* m) {
  if (!m) return;
  free(m->coords);
  free(m->elnodes);
  delete m;
}

// ---------------------------------------------------------------------------
// Gmsh ASCII (.msh), versions 2.2 and 4.1, tet10 element type 11.
// ---------------------------------------------------------------------------

FcvmMesh* fcvm_read_gmsh(const char* path) {
  std::ifstream f(path);
  if (!f) return nullptr;
  std::string line;
  double version = 0.0;
  MeshData m;
  std::vector<int64_t> tag_to_idx_keys;  // node tags (gmsh can be sparse)
  std::vector<double> xyz;
  std::vector<int64_t> tags;

  while (std::getline(f, line)) {
    if (starts_with(line, "$MeshFormat")) {
      std::getline(f, line);
      version = atof(line.c_str());
    } else if (starts_with(line, "$Nodes")) {
      if (version < 4.0) {
        std::getline(f, line);
        int64_t n = atoll(line.c_str());
        tags.reserve(n);
        xyz.reserve(n * 3);
        for (int64_t i = 0; i < n; ++i) {
          std::getline(f, line);
          std::istringstream ss(line);
          int64_t tag;
          double x, y, z;
          ss >> tag >> x >> y >> z;
          tags.push_back(tag);
          xyz.push_back(x);
          xyz.push_back(y);
          xyz.push_back(z);
        }
      } else {
        std::getline(f, line);
        std::istringstream hh(line);
        int64_t nblocks, n, mn, mx;
        hh >> nblocks >> n >> mn >> mx;
        for (int64_t b = 0; b < nblocks; ++b) {
          std::getline(f, line);
          std::istringstream bh(line);
          int64_t dim, etag, parametric, nb;
          bh >> dim >> etag >> parametric >> nb;
          std::vector<int64_t> btags(nb);
          for (int64_t i = 0; i < nb; ++i) {
            std::getline(f, line);
            btags[i] = atoll(line.c_str());
          }
          for (int64_t i = 0; i < nb; ++i) {
            std::getline(f, line);
            std::istringstream ss(line);
            double x, y, z;
            ss >> x >> y >> z;
            tags.push_back(btags[i]);
            xyz.push_back(x);
            xyz.push_back(y);
            xyz.push_back(z);
          }
        }
      }
    } else if (starts_with(line, "$Elements")) {
      // map node tag -> index
      int64_t maxtag = 0;
      for (auto t : tags) maxtag = std::max(maxtag, t);
      std::vector<int64_t> tag2idx(maxtag + 1, -1);
      for (size_t i = 0; i < tags.size(); ++i) tag2idx[tags[i]] = (int64_t)i;

      if (version < 4.0) {
        std::getline(f, line);
        int64_t n = atoll(line.c_str());
        for (int64_t i = 0; i < n; ++i) {
          std::getline(f, line);
          std::istringstream ss(line);
          int64_t tag, type, ntags;
          ss >> tag >> type >> ntags;
          int64_t skip;
          for (int64_t t = 0; t < ntags; ++t) ss >> skip;
          if (type == 11) {
            int64_t nd[10];
            for (int& g : (int[10]){0}) (void)g;
            for (int k = 0; k < 10; ++k) ss >> nd[k];
            int64_t row[10];
            for (int k = 0; k < 10; ++k) row[kGmshToFcvm[k]] = tag2idx[nd[k]];
            for (int k = 0; k < 10; ++k) m.elnodes.push_back(row[k]);
            ++m.ne;
          }
        }
      } else {
        std::getline(f, line);
        std::istringstream hh(line);
        int64_t nblocks, n, mn, mx;
        hh >> nblocks >> n >> mn >> mx;
        for (int64_t b = 0; b < nblocks; ++b) {
          std::getline(f, line);
          std::istringstream bh(line);
          int64_t dim, etag, type, nb;
          bh >> dim >> etag >> type >> nb;
          for (int64_t i = 0; i < nb; ++i) {
            std::getline(f, line);
            if (type != 11) continue;
            std::istringstream ss(line);
            int64_t tag, nd[10];
            ss >> tag;
            for (int k = 0; k < 10; ++k) ss >> nd[k];
            int64_t row[10];
            for (int k = 0; k < 10; ++k) row[kGmshToFcvm[k]] = tag2idx[nd[k]];
            for (int k = 0; k < 10; ++k) m.elnodes.push_back(row[k]);
            ++m.ne;
          }
        }
      }
    }
  }
  m.nn = (int64_t)tags.size();
  m.coords = std::move(xyz);
  if (m.nn == 0 || m.ne == 0) return nullptr;
  return wrap(std::move(m));
}

// ---------------------------------------------------------------------------
// UNV (SMESH / FreeCAD FemMesh export): datasets 2411 (nodes), 2412 (elements)
// ---------------------------------------------------------------------------

FcvmMesh* fcvm_read_unv(const char* path) {
  std::ifstream f(path);
  if (!f) return nullptr;
  std::string line;
  MeshData m;
  std::vector<int64_t> tags;
  std::vector<double> xyz;

  auto read_dataset_id = [&](const std::string& l) -> int {
    return atoi(l.c_str());
  };

  while (std::getline(f, line)) {
    // datasets start and end with a line containing "-1"
    std::string t = line;
    t.erase(0, t.find_first_not_of(" \t\r"));
    if (t.rfind("-1", 0) != 0) continue;
    if (!std::getline(f, line)) break;
    int ds = read_dataset_id(line);
    if (ds == 2411) {
      while (std::getline(f, line)) {
        std::string s = line;
        s.erase(0, s.find_first_not_of(" \t\r"));
        if (s.rfind("-1", 0) == 0) break;
        std::istringstream ss(line);
        int64_t tag, a, b, c;
        ss >> tag >> a >> b >> c;
        if (!std::getline(f, line)) break;
        // UNV uses Fortran D exponents
        for (auto& ch : line)
          if (ch == 'D' || ch == 'd') ch = 'E';
        std::istringstream cs(line);
        double x, y, z;
        cs >> x >> y >> z;
        tags.push_back(tag);
        xyz.push_back(x);
        xyz.push_back(y);
        xyz.push_back(z);
      }
    } else if (ds == 2412) {
      int64_t maxtag = 0;
      for (auto tg : tags) maxtag = std::max(maxtag, tg);
      std::vector<int64_t> tag2idx(maxtag + 1, -1);
      for (size_t i = 0; i < tags.size(); ++i) tag2idx[tags[i]] = (int64_t)i;
      while (std::getline(f, line)) {
        std::string s = line;
        s.erase(0, s.find_first_not_of(" \t\r"));
        if (s.rfind("-1", 0) == 0) break;
        std::istringstream ss(line);
        int64_t tag = 0, fe = 0, a = 0, b = 0, c = 0, nnodes = 0;
        if (!(ss >> tag >> fe >> a >> b >> c >> nnodes)) continue;
        // Beam-family elements (UNV FE 11/21/22/23/24) carry one extra
        // orientation record between the header and the node list; SMESH /
        // FreeCAD meshes include them for edge groups.
        if (fe == 11 || fe == 21 || fe == 22 || fe == 23 || fe == 24) {
          if (!std::getline(f, line)) break;
        }
        std::vector<int64_t> nd;
        while ((int64_t)nd.size() < nnodes && std::getline(f, line)) {
          std::istringstream ns(line);
          int64_t v;
          while (ns >> v) nd.push_back(v);
        }
        if (fe == 118 && nnodes == 10) {
          int64_t row[10];
          for (int k = 0; k < 10; ++k) row[kUnvToFcvm[k]] = tag2idx[nd[k]];
          for (int k = 0; k < 10; ++k) m.elnodes.push_back(row[k]);
          ++m.ne;
        }
      }
    } else {
      // skip to dataset end
      while (std::getline(f, line)) {
        std::string s = line;
        s.erase(0, s.find_first_not_of(" \t\r"));
        if (s.rfind("-1", 0) == 0) break;
      }
    }
  }
  m.nn = (int64_t)tags.size();
  m.coords = std::move(xyz);
  if (m.nn == 0 || m.ne == 0) return nullptr;
  return wrap(std::move(m));
}

// ---------------------------------------------------------------------------
// Graph preprocessing
// ---------------------------------------------------------------------------

// Node adjacency (corner+midside coupling through shared elements), CSR.
static void build_adjacency(int64_t nn, int64_t ne, const int64_t* elnodes,
                            std::vector<int64_t>& ptr,
                            std::vector<int64_t>& adj) {
  std::vector<std::vector<int64_t>> nbr(nn);
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t* nd = elnodes + 10 * e;
    for (int i = 0; i < 10; ++i)
      for (int j = 0; j < 10; ++j)
        if (i != j) nbr[nd[i]].push_back(nd[j]);
  }
  ptr.assign(nn + 1, 0);
  for (int64_t n = 0; n < nn; ++n) {
    auto& v = nbr[n];
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
    ptr[n + 1] = ptr[n] + (int64_t)v.size();
  }
  adj.resize(ptr[nn]);
  for (int64_t n = 0; n < nn; ++n)
    std::copy(nbr[n].begin(), nbr[n].end(), adj.begin() + ptr[n]);
}

// Reverse Cuthill-McKee: perm_out[new_index] = old_index.
int fcvm_rcm_order(int64_t nn, int64_t ne, const int64_t* elnodes,
                   int64_t* perm_out) {
  std::vector<int64_t> ptr, adj;
  build_adjacency(nn, ne, elnodes, ptr, adj);
  std::vector<int64_t> degree(nn);
  for (int64_t n = 0; n < nn; ++n) degree[n] = ptr[n + 1] - ptr[n];

  std::vector<char> visited(nn, 0);
  std::vector<int64_t> order;
  order.reserve(nn);
  for (;;) {
    // unvisited node of minimum degree as the next component's seed
    int64_t seed = -1;
    for (int64_t n = 0; n < nn; ++n)
      if (!visited[n] && (seed < 0 || degree[n] < degree[seed])) seed = n;
    if (seed < 0) break;
    std::queue<int64_t> q;
    q.push(seed);
    visited[seed] = 1;
    while (!q.empty()) {
      int64_t n = q.front();
      q.pop();
      order.push_back(n);
      std::vector<int64_t> next;
      for (int64_t k = ptr[n]; k < ptr[n + 1]; ++k)
        if (!visited[adj[k]]) {
          visited[adj[k]] = 1;
          next.push_back(adj[k]);
        }
      std::sort(next.begin(), next.end(), [&](int64_t a, int64_t b) {
        return degree[a] < degree[b];
      });
      for (auto v : next) q.push(v);
    }
  }
  std::reverse(order.begin(), order.end());
  std::copy(order.begin(), order.end(), perm_out);
  return 0;
}

// Elements adjacent to each node (the reference's `noce`, fcVM.py:183-185).
int fcvm_node_element_counts(int64_t nn, int64_t ne, const int64_t* elnodes,
                             int64_t* counts_out) {
  std::fill(counts_out, counts_out + nn, 0);
  for (int64_t i = 0; i < ne * 10; ++i) ++counts_out[elnodes[i]];
  return 0;
}

// Fast text formatting for the legacy-VTK writer (runtime/vtk.py): %.10g
// per value, `per_line` values per line.  Python-side float formatting of
// multi-hundred-MB exports costs seconds per analysis; this is the
// native-runtime IO path (caller frees with fcvm_free_str).
char* fcvm_format_doubles(const double* v, int64_t n, int per_line,
                          int64_t* len_out) {
  size_t cap = (size_t)n * 20 + 16;
  char* buf = (char*)std::malloc(cap);
  if (!buf) return nullptr;
  size_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (cap - pos < 32) {
      cap = cap * 2;
      char* nb = (char*)std::realloc(buf, cap);
      if (!nb) { std::free(buf); return nullptr; }
      buf = nb;
    }
    // std::to_chars: same text as printf %.10g, ~5x faster than snprintf
    auto res = std::to_chars(buf + pos, buf + cap - 2, v[i],
                             std::chars_format::general, 10);
    pos = (size_t)(res.ptr - buf);
    buf[pos++] = ((i + 1) % per_line == 0 || i + 1 == n) ? '\n' : ' ';
  }
  if (pos) --pos;  // strip the final newline (joined by caller)
  buf[pos] = 0;
  if (len_out) *len_out = (int64_t)pos;
  return buf;
}

// tet10 VTK cell lines: "10 n0 n1 ... n9" per element.
char* fcvm_format_cells(const int64_t* eln, int64_t ne, int64_t* len_out) {
  size_t cap = (size_t)ne * 11 * 13 + 16;
  char* buf = (char*)std::malloc(cap);
  if (!buf) return nullptr;
  size_t pos = 0;
  for (int64_t e = 0; e < ne; ++e) {
    pos += std::snprintf(buf + pos, cap - pos, "10");
    for (int k = 0; k < 10; ++k)
      pos += std::snprintf(buf + pos, cap - pos, " %lld",
                           (long long)eln[10 * e + k]);
    buf[pos++] = '\n';
  }
  if (pos) --pos;
  buf[pos] = 0;
  if (len_out) *len_out = (int64_t)pos;
  return buf;
}

void fcvm_free_str(char* s) { std::free(s); }

// Graph bandwidth (max |i-j| over coupled node pairs) — RCM quality metric.
int64_t fcvm_bandwidth(int64_t nn, int64_t ne, const int64_t* elnodes) {
  int64_t bw = 0;
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t* nd = elnodes + 10 * e;
    for (int i = 0; i < 10; ++i)
      for (int j = i + 1; j < 10; ++j)
        bw = std::max(bw, std::abs(nd[i] - nd[j]));
  }
  return bw;
}

}  // extern "C"
