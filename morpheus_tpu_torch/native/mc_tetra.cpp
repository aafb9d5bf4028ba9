// Native iso-surface extraction: marching tetrahedra with exact edge-keyed
// vertex dedup (the port's copy of native/mc_tetra.cpp, built into its own
// directory). Replaces the reference's PyMCubes C++ marching cubes
// (morpheus.py:399) — same surface accuracy, no case tables.
//
// Each lattice cube is split into 6 tetrahedra around the main diagonal;
// zero crossings are interpolated on tet edges; vertices are deduplicated by
// their (endpoint, endpoint) lattice-edge key so the mesh is watertight.
//
// C ABI (ctypes): mt_run mallocs outputs; mt_free releases them.

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct Result {
    std::vector<float> verts;
    std::vector<int32_t> faces;
};

// 6 tets sharing the (0,7) diagonal; corner bit layout: bit0=x, bit1=y, bit2=z
static const int TETS[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

struct Ctx {
    const float* sdf;
    int nx, ny, nz;
    float level;
    Result* out;
    std::unordered_map<uint64_t, int32_t> edge_cache;

    inline int64_t lid(int x, int y, int z) const {
        return (static_cast<int64_t>(x) * ny + y) * nz + z;
    }
    inline float val(int64_t id) const { return sdf[id] - level; }

    int32_t edge_vertex(int64_t a, int64_t b) {
        if (a > b) std::swap(a, b);
        uint64_t key = (static_cast<uint64_t>(a) << 32) ^ static_cast<uint64_t>(b);
        auto it = edge_cache.find(key);
        if (it != edge_cache.end()) return it->second;
        float va = val(a), vb = val(b);
        float t = va / (va - vb + 1e-30f);
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        // decode lattice coords
        int az = static_cast<int>(a % nz); int64_t ar = a / nz;
        int ay = static_cast<int>(ar % ny); int ax = static_cast<int>(ar / ny);
        int bz = static_cast<int>(b % nz); int64_t br = b / nz;
        int by = static_cast<int>(br % ny); int bx = static_cast<int>(br / ny);
        float px = ax + t * (bx - ax);
        float py = ay + t * (by - ay);
        float pz = az + t * (bz - az);
        int32_t idx = static_cast<int32_t>(out->verts.size() / 3);
        out->verts.push_back(px);
        out->verts.push_back(py);
        out->verts.push_back(pz);
        edge_cache.emplace(key, idx);
        return idx;
    }

    void emit(int32_t v0, int32_t v1, int32_t v2) {
        if (v0 == v1 || v1 == v2 || v0 == v2) return;
        out->faces.push_back(v0);
        out->faces.push_back(v1);
        out->faces.push_back(v2);
    }

    void do_tet(const int64_t c[4]) {
        int code = 0;
        for (int i = 0; i < 4; ++i)
            if (val(c[i]) < 0.f) code |= 1 << i;
        if (code == 0 || code == 15) return;

        auto one_inside = [&](int i) {
            int o[3], k = 0;
            for (int j = 0; j < 4; ++j) if (j != i) o[k++] = j;
            emit(edge_vertex(c[i], c[o[0]]), edge_vertex(c[i], c[o[1]]),
                 edge_vertex(c[i], c[o[2]]));
        };
        auto two_inside = [&](int a, int b) {
            int o[2], k = 0;
            for (int j = 0; j < 4; ++j) if (j != a && j != b) o[k++] = j;
            int32_t pa0 = edge_vertex(c[a], c[o[0]]);
            int32_t pa1 = edge_vertex(c[a], c[o[1]]);
            int32_t pb0 = edge_vertex(c[b], c[o[0]]);
            int32_t pb1 = edge_vertex(c[b], c[o[1]]);
            emit(pa0, pb0, pa1);
            emit(pa1, pb0, pb1);
        };

        switch (code) {
            case 1: one_inside(0); break;
            case 2: one_inside(1); break;
            case 4: one_inside(2); break;
            case 8: one_inside(3); break;
            case 14: one_inside(0); break;
            case 13: one_inside(1); break;
            case 11: one_inside(2); break;
            case 7: one_inside(3); break;
            case 3: two_inside(0, 1); break;
            case 5: two_inside(0, 2); break;
            case 9: two_inside(0, 3); break;
            case 6: two_inside(1, 2); break;
            case 10: two_inside(1, 3); break;
            case 12: two_inside(2, 3); break;
        }
    }
};

}  // namespace

extern "C" {

// Returns 0 on success. Outputs are malloc'd; release with mt_free.
int mt_run(const float* sdf, int nx, int ny, int nz, float level,
           float** out_verts, int64_t* n_verts,
           int32_t** out_faces, int64_t* n_faces) {
    if (nx < 2 || ny < 2 || nz < 2) {
        *out_verts = nullptr; *n_verts = 0;
        *out_faces = nullptr; *n_faces = 0;
        return 0;
    }
    Result res;
    Ctx ctx{sdf, nx, ny, nz, level, &res, {}};
    ctx.edge_cache.reserve(1 << 16);

    int64_t corners[8];
    for (int x = 0; x < nx - 1; ++x) {
        for (int y = 0; y < ny - 1; ++y) {
            for (int z = 0; z < nz - 1; ++z) {
                // skip cubes with no sign change (fast path)
                bool neg = false, pos = false;
                for (int c = 0; c < 8; ++c) {
                    corners[c] = ctx.lid(x + (c & 1), y + ((c >> 1) & 1),
                                         z + ((c >> 2) & 1));
                    (ctx.val(corners[c]) < 0.f ? neg : pos) = true;
                }
                if (!neg || !pos) continue;
                for (int t = 0; t < 6; ++t) {
                    int64_t tet[4] = {corners[TETS[t][0]], corners[TETS[t][1]],
                                      corners[TETS[t][2]], corners[TETS[t][3]]};
                    ctx.do_tet(tet);
                }
            }
        }
    }

    *n_verts = static_cast<int64_t>(res.verts.size() / 3);
    *n_faces = static_cast<int64_t>(res.faces.size() / 3);
    *out_verts = static_cast<float*>(malloc(res.verts.size() * sizeof(float)));
    *out_faces = static_cast<int32_t*>(malloc(res.faces.size() * sizeof(int32_t)));
    if ((res.verts.size() && !*out_verts) || (res.faces.size() && !*out_faces))
        return 1;
    if (res.verts.size())
        std::copy(res.verts.begin(), res.verts.end(), *out_verts);
    if (res.faces.size())
        std::copy(res.faces.begin(), res.faces.end(), *out_faces);
    return 0;
}

void mt_free(void* p) { free(p); }

}  // extern "C"
