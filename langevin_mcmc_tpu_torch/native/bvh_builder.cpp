// Native BVH build: binned-SAH, flattened-node output (a copy of the
// JAX package's native/bvh_builder.cpp; the port imports nothing of it).
//
// Host-side native counterpart of Embree's BVH build phase (the reference
// links the full embree3 tree for rtcNewScene/rtcCommitScene — reference
// src/scene.cpp:29-45). The traversal runs on the device (ops/bvh.py,
// csrc/bvh.cu); this code produces the same flattened [N, 8] float32
// node layout as build_bvh (numpy) in ops/bvh.py, and is built with g++ at
// first use and loaded via ctypes (native/__init__.py).
//
// Node layout (must match ops/bvh.py):
//   [0:3] bbox min, [3:6] bbox max,
//   [6]   left child (inner) | first primitive offset (leaf)
//   [7]   > 0: leaf primitive count; <= 0: -right child index (inner)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxLeaf = 4;
constexpr int kBuckets = 12;

struct Box {
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    void grow(const float* l, const float* h) {
        for (int k = 0; k < 3; ++k) {
            lo[k] = std::min(lo[k], l[k]);
            hi[k] = std::max(hi[k], h[k]);
        }
    }
    void grow(const Box& b) { grow(b.lo, b.hi); }
    float area() const {
        float d[3] = {std::max(hi[0] - lo[0], 0.f),
                      std::max(hi[1] - lo[1], 0.f),
                      std::max(hi[2] - lo[2], 0.f)};
        return 2.f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
    }
};

struct SahBuild {
    const float* lo;       // [T, 3]
    const float* hi;       // [T, 3]
    std::vector<float> centers;
    std::vector<float> nodes;       // N x 8
    std::vector<int32_t> prims;

    int emit_node() {
        nodes.insert(nodes.end(), 8, 0.f);
        return int(nodes.size() / 8) - 1;
    }

    // Recursive build over ids[begin, end); returns node index.
    int build(std::vector<int32_t>& ids, int begin, int end) {
        int node_id = emit_node();
        Box nb;
        for (int i = begin; i < end; ++i)
            nb.grow(lo + 3 * ids[i], hi + 3 * ids[i]);
        float* n = &nodes[8 * node_id];
        std::memcpy(n, nb.lo, 12);
        std::memcpy(n + 3, nb.hi, 12);

        int count = end - begin;
        if (count <= kMaxLeaf) {
            n = &nodes[8 * node_id];
            n[6] = float(prims.size());
            n[7] = float(count);
            for (int i = begin; i < end; ++i) prims.push_back(ids[i]);
            return node_id;
        }

        // centroid bounds + split axis
        Box cb;
        for (int i = begin; i < end; ++i) {
            const float* c = &centers[3 * ids[i]];
            cb.grow(c, c);
        }
        int axis = 0;
        float ext[3] = {cb.hi[0] - cb.lo[0], cb.hi[1] - cb.lo[1],
                        cb.hi[2] - cb.lo[2]};
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid;
        if (ext[axis] <= 1e-12f) {
            mid = begin + count / 2;
        } else {
            Box blo[kBuckets];
            Box bhi[kBuckets];
            int cnt[kBuckets] = {0};
            auto bucket_of = [&](int id) {
                float t = (centers[3 * id + axis] - cb.lo[axis]) / ext[axis];
                int b = int(t * kBuckets);
                return std::min(std::max(b, 0), kBuckets - 1);
            };
            for (int i = begin; i < end; ++i) {
                int b = bucket_of(ids[i]);
                cnt[b]++;
                blo[b].grow(lo + 3 * ids[i], hi + 3 * ids[i]);
            }
            // prefix/suffix sweeps
            Box pre[kBuckets], suf[kBuckets];
            int pre_cnt[kBuckets], suf_cnt[kBuckets];
            Box acc;
            int ac = 0;
            for (int b = 0; b < kBuckets; ++b) {
                acc.grow(blo[b]); ac += cnt[b];
                pre[b] = acc; pre_cnt[b] = ac;
            }
            acc = Box(); ac = 0;
            for (int b = kBuckets - 1; b >= 0; --b) {
                acc.grow(blo[b]); ac += cnt[b];
                suf[b] = acc; suf_cnt[b] = ac;
            }
            float best = 1e30f;
            int best_s = -1;
            for (int s = 0; s < kBuckets - 1; ++s) {
                if (pre_cnt[s] == 0 || suf_cnt[s + 1] == 0) continue;
                float cost = pre[s].area() * pre_cnt[s]
                           + suf[s + 1].area() * suf_cnt[s + 1];
                if (cost < best) { best = cost; best_s = s; }
            }
            if (best_s < 0) {
                std::sort(ids.begin() + begin, ids.begin() + end,
                          [&](int a, int b) {
                              return centers[3 * a + axis] < centers[3 * b + axis];
                          });
                mid = begin + count / 2;
            } else {
                auto it = std::partition(
                    ids.begin() + begin, ids.begin() + end,
                    [&](int id) { return bucket_of(id) <= best_s; });
                mid = int(it - ids.begin());
                if (mid == begin || mid == end) mid = begin + count / 2;
            }
        }

        int left = build(ids, begin, mid);
        int right = build(ids, mid, end);
        n = &nodes[8 * node_id];
        n[6] = float(left);
        n[7] = -float(right);
        return node_id;
    }
};

}  // namespace

extern "C" {

// Returns number of nodes; fills nodes_out (cap_nodes*8 floats) and
// prim_ids_out (num_tris ints). Returns -1 if capacity insufficient.
int lmcmc_build_bvh(const float* tri_lo, const float* tri_hi,
                    int num_tris, float* nodes_out, int cap_nodes,
                    int32_t* prim_ids_out) {
    SahBuild b;
    b.lo = tri_lo;
    b.hi = tri_hi;
    b.centers.resize(3 * num_tris);
    for (int i = 0; i < 3 * num_tris; ++i)
        b.centers[i] = 0.5f * (tri_lo[i] + tri_hi[i]);
    std::vector<int32_t> ids(num_tris);
    for (int i = 0; i < num_tris; ++i) ids[i] = i;
    b.nodes.reserve(size_t(num_tris) * 16);
    b.prims.reserve(num_tris);
    b.build(ids, 0, num_tris);
    int n_nodes = int(b.nodes.size() / 8);
    if (n_nodes > cap_nodes) return -1;
    std::memcpy(nodes_out, b.nodes.data(), b.nodes.size() * 4);
    std::memcpy(prim_ids_out, b.prims.data(), b.prims.size() * 4);
    return n_nodes;
}

}  // extern "C"
