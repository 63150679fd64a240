// Native KD-tree builder: the C++ twin of accel/kd_build.py.
//
// The reference does its n·log n median-split build in C++ on the host
// (TEST_Dungeonrun/Trixel.h:135-385); the numpy builder is exact but pays
// interpreter overhead per node, which matters at 800k triangles. This is
// the identical algorithm (six sorted AABB orders, max-spread cut with the
// reference's probe order and strict-greater tie-breaking, median split with
// ranks <= m going left, child bounds off the sorted orders, s1/s2 split
// planes) behind a C ABI consumed via ctypes (accel/native.py), with the
// same outputs as build_kd(), bit for bit (tests/test_torch_native.py).
//
// accel/native.py builds it at first use into build/native/:
// g++ -O3 -march=native -ffp-contract=off -shared -fPIC

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// cut codes 0..5 = x1, y1, z1, x0, y0, z0 (Trixel.h:172-193)
constexpr int kProbeOrder[6] = {0, 3, 1, 4, 2, 5};

struct BuildCtx {
    const double* keys[6];  // per-code key array, length n
    std::vector<int64_t> orders[6];
};

}  // namespace

extern "C" {

// Returns number of nodes written, or -1 on error. Output arrays must have
// capacity 2*n (nodes) / n (perm).
int64_t kd_build(const float* aabb_min, const float* aabb_max, int64_t n,
                 int64_t min_node_size,
                 float* bounds_min, float* bounds_max, int8_t* cut_code,
                 float* s1, float* s2, int32_t* left, int32_t* right,
                 int32_t* parent, int32_t* leaf_start, int32_t* leaf_count,
                 int64_t* perm) {
    if (n <= 0 || min_node_size <= 0) return -1;

    // keys in cut-code order: x1,y1,z1 from aabb_max, x0,y0,z0 from aabb_min
    std::vector<double> key_store(static_cast<size_t>(6 * n));
    BuildCtx ctx;
    for (int c = 0; c < 6; ++c) {
        double* k = key_store.data() + c * n;
        const float* src = (c < 3) ? aabb_max : aabb_min;
        int axis = c % 3;
        for (int64_t i = 0; i < n; ++i) k[i] = src[i * 3 + axis];
        ctx.keys[c] = k;
        ctx.orders[c].resize(n);
        for (int64_t i = 0; i < n; ++i) ctx.orders[c][i] = i;
        std::stable_sort(ctx.orders[c].begin(), ctx.orders[c].end(),
                         [k](int64_t a, int64_t b) { return k[a] < k[b]; });
    }

    auto write_bounds = [&](int64_t node, int64_t l, int64_t r) {
        for (int axis = 0; axis < 3; ++axis) {
            bounds_min[node * 3 + axis] =
                static_cast<float>(ctx.keys[3 + axis][ctx.orders[3 + axis][l]]);
            bounds_max[node * 3 + axis] =
                static_cast<float>(ctx.keys[axis][ctx.orders[axis][r]]);
        }
    };

    std::vector<std::pair<int64_t, int64_t>> ranges(static_cast<size_t>(2 * n));
    std::vector<uint8_t> in_left(static_cast<size_t>(n), 0);
    std::vector<int64_t> scratch(static_cast<size_t>(n));

    ranges[0] = {0, n - 1};
    write_bounds(0, 0, n - 1);
    parent[0] = 0;
    int64_t write_index = 1;
    for (int64_t read_index = 0; read_index < write_index; ++read_index) {
        const int64_t l = ranges[read_index].first;
        const int64_t r = ranges[read_index].second;
        const int64_t count = r - l + 1;
        if (count <= min_node_size) {
            left[read_index] = -1;
            right[read_index] = -1;
            leaf_start[read_index] = static_cast<int32_t>(l);
            leaf_count[read_index] = static_cast<int32_t>(count);
            cut_code[read_index] = cut_code[parent[read_index]];
            continue;
        }
        leaf_start[read_index] = -1;
        leaf_count[read_index] = 0;

        int best_code = 0;
        double best_spread =
            ctx.keys[0][ctx.orders[0][r]] - ctx.keys[0][ctx.orders[0][l]];
        for (int pi = 1; pi < 6; ++pi) {
            int code = kProbeOrder[pi];
            double spread = ctx.keys[code][ctx.orders[code][r]] -
                            ctx.keys[code][ctx.orders[code][l]];
            if (spread > best_spread) {
                best_spread = spread;
                best_code = code;
            }
        }
        cut_code[read_index] = static_cast<int8_t>(best_code);

        const int64_t m = (r - l) / 2 + l;
        auto& cut_order = ctx.orders[best_code];
        for (int64_t i = l; i <= m; ++i) in_left[cut_order[i]] = 1;
        for (int c = 0; c < 6; ++c) {
            if (c == best_code) continue;
            auto& ord = ctx.orders[c];
            int64_t lo = 0, hi = m - l + 1;
            for (int64_t i = l; i <= r; ++i) {
                scratch[in_left[ord[i]] ? lo++ : hi++] = ord[i];
            }
            std::memcpy(ord.data() + l, scratch.data(),
                        sizeof(int64_t) * count);
        }
        for (int64_t i = l; i <= m; ++i) in_left[cut_order[i]] = 0;

        const int64_t li = write_index, ri = write_index + 1;
        left[read_index] = static_cast<int32_t>(li);
        right[read_index] = static_cast<int32_t>(ri);
        parent[li] = static_cast<int32_t>(read_index);
        parent[ri] = static_cast<int32_t>(read_index);
        write_bounds(li, l, m);
        write_bounds(ri, m + 1, r);
        ranges[li] = {l, m};
        ranges[ri] = {m + 1, r};
        const int axis = best_code % 3;
        s1[read_index] = bounds_max[li * 3 + axis];
        s2[read_index] = bounds_min[ri * 3 + axis];
        write_index += 2;
    }

    std::memcpy(perm, ctx.orders[0].data(), sizeof(int64_t) * n);
    return write_index;
}

}  // extern "C"
