// Native BVH builder for rayzath_tpu.
//
// Host-side equivalent of the reference's C++ tree builds
// (RayZath/bvh_tree_node.hpp:117-215 for instances,
// RayZath/component_container.hpp:145-364 for triangles), emitting the
// flattened SoA layout consumed directly by the BVH walk
// (rayzath_tpu/ops/traverse.py):
//
//   * DFS node order with both children adjacent (inner node stores the index
//     of its FIRST child + its split axis; leaf stores [begin, count) into the
//     reordered primitive array; count == 0 marks an inner node),
//   * split point = mean of primitive centroids,
//   * split axis  = axis of maximum centroid variance,
//   * degenerate splits fall back to a stable median sort,
//   * leaf size and max depth caps match the reference (8 / 31).
//
// The algorithm is identical to the NumPy fallback in rayzath_tpu/ops/bvh.py;
// statistics are accumulated in double, as NumPy does for the comparison-level
// precision that decides splits. Exposed through a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Builder {
    const float* prim_min;  // [n,3]
    const float* prim_max;  // [n,3]
    int leaf_size;
    int max_depth;
    std::vector<float> centroids;  // [n,3]

    // output arrays (node-major), appended in DFS order
    std::vector<float> node_min, node_max;
    std::vector<int32_t> node_begin, node_count, node_axis;
    std::vector<int32_t> order;  // primitive permutation (new -> old)

    int alloc_node() {
        node_min.insert(node_min.end(), {0.f, 0.f, 0.f});
        node_max.insert(node_max.end(), {0.f, 0.f, 0.f});
        node_begin.push_back(0);
        node_count.push_back(0);
        node_axis.push_back(0);
        return static_cast<int>(node_begin.size()) - 1;
    }

    void emit_leaf(int node_id, const int32_t* idx, int count) {
        node_begin[node_id] = static_cast<int32_t>(order.size());
        node_count[node_id] = count;
        order.insert(order.end(), idx, idx + count);
    }

    // Build the subtree for primitives idx[0..count). `idx` is scratch space
    // owned by the caller and may be permuted in place.
    void build(int node_id, int32_t* idx, int count, int depth) {
        float bmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
        float bmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
        for (int i = 0; i < count; ++i) {
            const float* pmin = prim_min + 3 * idx[i];
            const float* pmax = prim_max + 3 * idx[i];
            for (int a = 0; a < 3; ++a) {
                bmin[a] = std::min(bmin[a], pmin[a]);
                bmax[a] = std::max(bmax[a], pmax[a]);
            }
        }
        std::memcpy(&node_min[3 * node_id], bmin, sizeof bmin);
        std::memcpy(&node_max[3 * node_id], bmax, sizeof bmax);

        if (count <= leaf_size || depth >= max_depth) {
            emit_leaf(node_id, idx, count);
            return;
        }

        // too-large-object partition (reference Size partition type,
        // bvh_tree_node.hpp:127-148): primitives spanning the node box in
        // every axis get their own child. Axes the node is flat in count as
        // satisfied (see the NumPy builder for the rationale); the
        // stable-partition order matches NumPy's boolean-mask selection.
        {
            float node_sz[3];
            float max_sz = 0.f;
            for (int a = 0; a < 3; ++a) {
                node_sz[a] = bmax[a] - bmin[a];
                max_sz = std::max(max_sz, node_sz[a]);
            }
            const float eps = 1e-12f + 1e-6f * max_sz;
            auto is_small = [&](int32_t p) {
                const float* pmin = prim_min + 3 * p;
                const float* pmax = prim_max + 3 * p;
                for (int a = 0; a < 3; ++a) {
                    const float psz = pmax[a] - pmin[a];
                    if (!(psz < node_sz[a] || node_sz[a] <= eps)) return false;
                }
                return true;
            };
            int n_small = 0;
            for (int i = 0; i < count; ++i) n_small += is_small(idx[i]);
            if (n_small == 0) {  // only too-large primitives: leaf
                emit_leaf(node_id, idx, count);
                return;
            }
            if (n_small < count) {
                std::vector<int32_t> tmp(idx, idx + count);
                int w = 0;
                for (int i = 0; i < count; ++i)
                    if (is_small(tmp[i])) idx[w++] = tmp[i];
                for (int i = 0; i < count; ++i)
                    if (!is_small(tmp[i])) idx[w++] = tmp[i];
                const int left_id = alloc_node();
                const int right_id = alloc_node();
                (void)right_id;
                node_begin[node_id] = left_id;
                node_count[node_id] = 0;
                node_axis[node_id] = 0;
                build(left_id, idx, n_small, depth + 1);
                build(right_id, idx + n_small, count - n_small, depth + 1);
                return;
            }
        }

        // centroid mean + variance per axis (double accumulation)
        double sum[3] = {0, 0, 0}, sum2[3] = {0, 0, 0};
        for (int i = 0; i < count; ++i) {
            const float* c = &centroids[3 * idx[i]];
            for (int a = 0; a < 3; ++a) {
                sum[a] += c[a];
                sum2[a] += static_cast<double>(c[a]) * c[a];
            }
        }
        int axis = 0;
        double best_var = -1.0;
        double mean[3];
        for (int a = 0; a < 3; ++a) {
            mean[a] = sum[a] / count;
            double var = sum2[a] / count - mean[a] * mean[a];
            if (var > best_var) {
                best_var = var;
                axis = a;
            }
        }
        const float split = static_cast<float>(mean[axis]);

        // partition: centroid < split goes left (stable, like the boolean-mask
        // selection in the NumPy builder)
        auto centroid = [&](int32_t p) { return centroids[3 * p + axis]; };
        std::vector<int32_t> tmp(idx, idx + count);
        int n_left = 0;
        for (int i = 0; i < count; ++i)
            if (centroid(tmp[i]) < split) idx[n_left++] = tmp[i];
        int w = n_left;
        for (int i = 0; i < count; ++i)
            if (!(centroid(tmp[i]) < split)) idx[w++] = tmp[i];

        if (n_left == 0 || n_left == count) {
            // degenerate: stable median split on the centroid ordering
            std::stable_sort(idx, idx + count, [&](int32_t a, int32_t b) {
                return centroid(a) < centroid(b);
            });
            n_left = count / 2;
        }

        const int left_id = alloc_node();
        const int right_id = alloc_node();
        (void)right_id;  // right_id == left_id + 1 by construction
        node_begin[node_id] = left_id;
        node_count[node_id] = 0;
        node_axis[node_id] = axis;
        build(left_id, idx, n_left, depth + 1);
        build(right_id, idx + n_left, count - n_left, depth + 1);
    }
};

}  // namespace

extern "C" {

// Builds the BVH. Output buffers must be sized for the worst case:
// node arrays for 2n-1 nodes, `order` for n entries. Returns the node count
// actually written (>= 1), or -1 on invalid arguments.
int rz_bvh_build(const float* prim_min, const float* prim_max, int n,
                 int leaf_size, int max_depth,
                 float* out_node_min, float* out_node_max,
                 int32_t* out_node_begin, int32_t* out_node_count,
                 int32_t* out_node_axis, int32_t* out_order) {
    if (n < 0 || leaf_size < 1 || max_depth < 1) return -1;
    if (n == 0) {
        for (int a = 0; a < 3; ++a) out_node_min[a] = out_node_max[a] = 0.f;
        out_node_begin[0] = out_node_count[0] = out_node_axis[0] = 0;
        return 1;
    }
    Builder b;
    b.prim_min = prim_min;
    b.prim_max = prim_max;
    b.leaf_size = leaf_size;
    b.max_depth = max_depth;
    b.centroids.resize(3 * static_cast<size_t>(n));
    for (size_t i = 0; i < 3 * static_cast<size_t>(n); ++i)
        b.centroids[i] = 0.5f * (prim_min[i] + prim_max[i]);
    const size_t max_nodes = 2 * static_cast<size_t>(n) - 1;
    b.node_min.reserve(3 * max_nodes);
    b.node_max.reserve(3 * max_nodes);
    b.node_begin.reserve(max_nodes);
    b.node_count.reserve(max_nodes);
    b.node_axis.reserve(max_nodes);
    b.order.reserve(n);

    std::vector<int32_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);
    const int root = b.alloc_node();
    b.build(root, idx.data(), n, 0);

    const int n_nodes = static_cast<int>(b.node_begin.size());
    std::memcpy(out_node_min, b.node_min.data(), b.node_min.size() * sizeof(float));
    std::memcpy(out_node_max, b.node_max.data(), b.node_max.size() * sizeof(float));
    std::memcpy(out_node_begin, b.node_begin.data(), n_nodes * sizeof(int32_t));
    std::memcpy(out_node_count, b.node_count.data(), n_nodes * sizeof(int32_t));
    std::memcpy(out_node_axis, b.node_axis.data(), n_nodes * sizeof(int32_t));
    std::memcpy(out_order, b.order.data(), b.order.size() * sizeof(int32_t));
    return n_nodes;
}

// Per-octant stackless traversal tables (see ops/bvh.py compute_skip_links):
// out_first/out_skip are [8*n] octant-major. Parents precede children in the
// builder's allocation order, so one forward sweep per octant suffices.
int rz_bvh_skip_links(const int32_t* node_begin, const int32_t* node_count,
                      const int32_t* node_axis, int n,
                      int32_t* out_first, int32_t* out_skip) {
    if (n < 0) return -1;
    for (int o = 0; o < 8; ++o) {
        int32_t* first = out_first + static_cast<size_t>(o) * n;
        int32_t* skip = out_skip + static_cast<size_t>(o) * n;
        for (int i = 0; i < n; ++i) first[i] = skip[i] = n;
        for (int i = 0; i < n; ++i) {
            if (node_count[i] == 0) {
                const int bit = (o >> node_axis[i]) & 1;
                const int32_t near_c = node_begin[i] + bit;
                const int32_t far_c = node_begin[i] + 1 - bit;
                first[i] = near_c;
                skip[near_c] = far_c;
                skip[far_c] = skip[i];
            }
        }
    }
    return 0;
}

}  // extern "C"
