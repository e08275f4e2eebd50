// Native host-side spatial kernels for the graph-precompute layer (a copy
// of acceleratedvolrenderer_tpu/native/kdtree.cpp, built with the same
// flags, so that both packages merge bit for bit alike on one machine).
//
// The graph builder merges scatter points into cache vertices by
// sequential insertion: each point joins the nearest vertex within the
// node radius or founds a new one.  This library provides that exact merge
// and a static KD-tree for the kNN and radius queries behind the render
// search ranges and the reinforcement criteria.  It is compiled with g++
// at first use and loaded with ctypes (native/__init__.py).
//
// All functions use a C ABI; coordinates are float32 xyz triplets.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <queue>

extern "C" {

// ---------------------------------------------------------------------------
// Sequential radius merge (FreeGraphBuilder vertex insertion semantics):
// for each point in order, find the nearest existing vertex within
// `radius`; if found, assign the point to it (label = vertex id) and bump
// its weight; otherwise create a new vertex at the point.  Grid-hash
// accelerated but EXACT: candidate cells cover the full radius ball.
//
// Returns the number of vertices.  labels: n entries.  verts: capacity
// 3*n floats (only 3*count used).  counts: capacity n ints.
int avrt_merge_points(const float* pts, int64_t n, float radius,
                      int32_t* labels, float* verts, int32_t* counts) {
    if (n <= 0) return 0;
    const float r2 = radius * radius;
    const float cell = radius > 0 ? radius : 1e-6f;
    struct CellKey {
        int32_t x, y, z;
        bool operator==(const CellKey& o) const {
            return x == o.x && y == o.y && z == o.z;
        }
    };
    struct CellHash {
        size_t operator()(const CellKey& k) const {
            return (size_t)(uint32_t)k.x * 73856093u
                 ^ (size_t)(uint32_t)k.y * 19349663u
                 ^ (size_t)(uint32_t)k.z * 83492791u;
        }
    };
    std::unordered_map<CellKey, std::vector<int32_t>, CellHash> grid;
    grid.reserve((size_t)n * 2);
    int32_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
        const int32_t cx = (int32_t)std::floor(px / cell);
        const int32_t cy = (int32_t)std::floor(py / cell);
        const int32_t cz = (int32_t)std::floor(pz / cell);
        int32_t best = -1;
        float bestd2 = r2;
        for (int dz = -1; dz <= 1; ++dz)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dx = -1; dx <= 1; ++dx) {
                    auto it = grid.find(CellKey{cx + dx, cy + dy, cz + dz});
                    if (it == grid.end()) continue;
                    for (int32_t v : it->second) {
                        const float ddx = verts[3 * v] - px;
                        const float ddy = verts[3 * v + 1] - py;
                        const float ddz = verts[3 * v + 2] - pz;
                        const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                        if (d2 <= bestd2) { bestd2 = d2; best = v; }
                    }
                }
        if (best >= 0) {
            labels[i] = best;
            counts[best] += 1;
        } else {
            const int32_t v = count++;
            verts[3 * v] = px; verts[3 * v + 1] = py; verts[3 * v + 2] = pz;
            counts[v] = 1;
            labels[i] = v;
            grid[CellKey{cx, cy, cz}].push_back(v);
        }
    }
    return count;
}

// ---------------------------------------------------------------------------
// Static 3D KD-tree (nanoflann-equivalent): build once, query kNN and
// radius counts.  Median-split, leaf size 16.
struct KDNode {
    float split;
    int32_t axis;       // -1 => leaf
    int32_t left, right;  // children, or [start, end) into order for leaves
};

struct KDTree {
    std::vector<float> pts;       // 3*n
    std::vector<int32_t> order;   // permutation
    std::vector<KDNode> nodes;
    int64_t n;

    int32_t build(int64_t lo, int64_t hi) {
        const int32_t id = (int32_t)nodes.size();
        nodes.push_back({});
        if (hi - lo <= 16) {
            nodes[id] = {0.0f, -1, (int32_t)lo, (int32_t)hi};
            return id;
        }
        float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = lo; i < hi; ++i)
            for (int a = 0; a < 3; ++a) {
                const float v = pts[3 * order[i] + a];
                mn[a] = std::min(mn[a], v); mx[a] = std::max(mx[a], v);
            }
        int axis = 0;
        for (int a = 1; a < 3; ++a)
            if (mx[a] - mn[a] > mx[axis] - mn[axis]) axis = a;
        const int64_t mid = (lo + hi) / 2;
        std::nth_element(order.begin() + lo, order.begin() + mid,
                         order.begin() + hi,
                         [&](int32_t a, int32_t b) {
                             return pts[3 * a + axis] < pts[3 * b + axis];
                         });
        const float split = pts[3 * order[mid] + axis];
        const int32_t l = build(lo, mid);
        const int32_t r = build(mid, hi);
        nodes[id] = {split, axis, l, r};
        return id;
    }
};

void* avrt_kd_build(const float* pts, int64_t n) {
    KDTree* t = new KDTree();
    t->n = n;
    t->pts.assign(pts, pts + 3 * n);
    t->order.resize(n);
    for (int64_t i = 0; i < n; ++i) t->order[i] = (int32_t)i;
    if (n > 0) t->build(0, n);
    return t;
}

void avrt_kd_free(void* h) { delete (KDTree*)h; }

static void knn_rec(const KDTree* t, int32_t node, const float* q, int k,
                    std::priority_queue<std::pair<float, int32_t>>& heap) {
    const KDNode& nd = t->nodes[node];
    if (nd.axis < 0) {
        for (int32_t i = nd.left; i < nd.right; ++i) {
            const int32_t p = t->order[i];
            const float dx = t->pts[3 * p] - q[0];
            const float dy = t->pts[3 * p + 1] - q[1];
            const float dz = t->pts[3 * p + 2] - q[2];
            const float d2 = dx * dx + dy * dy + dz * dz;
            if ((int)heap.size() < k) heap.push({d2, p});
            else if (d2 < heap.top().first) { heap.pop(); heap.push({d2, p}); }
        }
        return;
    }
    const float delta = q[nd.axis] - nd.split;
    const int32_t near = delta <= 0 ? nd.left : nd.right;
    const int32_t far = delta <= 0 ? nd.right : nd.left;
    knn_rec(t, near, q, k, heap);
    if ((int)heap.size() < k || delta * delta < heap.top().first)
        knn_rec(t, far, q, k, heap);
}

// k nearest neighbours for nq queries; out_idx/out_d2: nq*k, padded with
// -1 / inf when fewer than k points exist.
void avrt_kd_knn(void* h, const float* queries, int64_t nq, int32_t k,
                 int32_t* out_idx, float* out_d2) {
    KDTree* t = (KDTree*)h;
    for (int64_t qi = 0; qi < nq; ++qi) {
        std::priority_queue<std::pair<float, int32_t>> heap;
        if (t->n > 0) knn_rec(t, 0, queries + 3 * qi, k, heap);
        int32_t m = (int32_t)heap.size();
        for (int32_t j = m; j < k; ++j) {
            out_idx[qi * k + j] = -1;
            out_d2[qi * k + j] = INFINITY;
        }
        for (int32_t j = m - 1; j >= 0; --j) {
            out_idx[qi * k + j] = heap.top().second;
            out_d2[qi * k + j] = heap.top().first;
            heap.pop();
        }
    }
}

static void radius_rec(const KDTree* t, int32_t node, const float* q,
                       float r2, int32_t* count, float* sumd2) {
    const KDNode& nd = t->nodes[node];
    if (nd.axis < 0) {
        for (int32_t i = nd.left; i < nd.right; ++i) {
            const int32_t p = t->order[i];
            const float dx = t->pts[3 * p] - q[0];
            const float dy = t->pts[3 * p + 1] - q[1];
            const float dz = t->pts[3 * p + 2] - q[2];
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 <= r2) { ++*count; *sumd2 += d2; }
        }
        return;
    }
    const float delta = q[nd.axis] - nd.split;
    const int32_t near = delta <= 0 ? nd.left : nd.right;
    const int32_t far = delta <= 0 ? nd.right : nd.left;
    radius_rec(t, near, q, r2, count, sumd2);
    if (delta * delta <= r2) radius_rec(t, far, q, r2, count, sumd2);
}

// radius search: per query, the in-radius count and sum of squared dists
// (what the analyzer/builder statistics consume).
void avrt_kd_radius_stats(void* h, const float* queries, int64_t nq,
                          float r2, int32_t* counts, float* sumd2) {
    KDTree* t = (KDTree*)h;
    for (int64_t qi = 0; qi < nq; ++qi) {
        counts[qi] = 0;
        sumd2[qi] = 0.0f;
        if (t->n > 0)
            radius_rec(t, 0, queries + 3 * qi, r2, &counts[qi], &sumd2[qi]);
    }
}

}  // extern "C"
