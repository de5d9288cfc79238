// Native host-runtime kernels for the simpleslam_tpu SLAM framework.
//
// The reference implements its host runtime in C++ (pcp voxel filters
// common/pcp/pcp.hpp:78-263, OpenMP cloud transform pcp.hpp:44-76, PCD/bag
// IO). These are their equivalents for OUR host side: everything on the
// device path is JAX/XLA; these kernels cover the host-only hot loops that
// feed it — keyframe cloud downsampling, NaN-strip + padding into the fixed
// capacity device layout, and submap assembly (transform + concat + voxel
// dedup). Exposed extern "C" for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -fopenmp hostops.cpp -o libhostops.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <utility>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Finalizer-style 64-bit mixer (murmur3 fmix64). A bare multiply-and-mask
// hash takes the LOW bits of key * C, which depend only on the low bits of
// the key — and the packed voxel key keeps iz in the low 21 bits, where a
// ground-vehicle scan spans ~8 values. That collapsed every point onto a
// handful of probe-start slots (measured: kilo-length linear-probe chains,
// ~335 ns/point). The full mixer folds the high bits (ix, iy) back down.
inline uint64_t mix64(uint64_t k) {
    k ^= k >> 33;
    k *= 0xFF51AFD7ED558CCDULL;
    k ^= k >> 33;
    k *= 0xC4CEB9FE1A85EC53ULL;
    k ^= k >> 33;
    return k;
}

// Open-addressing int64 hash set for voxel keys (linear probing).
struct KeySet {
    std::vector<int64_t> slots;
    std::vector<uint8_t> used;
    size_t mask;
    explicit KeySet(size_t expected) {
        size_t cap = 64;
        while (cap < expected * 2) cap <<= 1;
        slots.assign(cap, 0);
        used.assign(cap, 0);
        mask = cap - 1;
    }
    // returns true if the key was newly inserted
    bool insert(int64_t key) {
        size_t h = static_cast<size_t>(mix64(static_cast<uint64_t>(key))) & mask;
        while (used[h]) {
            if (slots[h] == key) return false;
            h = (h + 1) & mask;
        }
        used[h] = 1;
        slots[h] = key;
        return true;
    }
};

inline int64_t voxel_key(float x, float y, float z, float inv_grid) {
    // 21 bits per axis, offset to positive — ~±1e6 voxel range
    const int64_t off = 1 << 20;
    int64_t ix = static_cast<int64_t>(std::floor(x * inv_grid)) + off;
    int64_t iy = static_cast<int64_t>(std::floor(y * inv_grid)) + off;
    int64_t iz = static_cast<int64_t>(std::floor(z * inv_grid)) + off;
    return (ix << 42) | (iy << 21) | iz;
}

}  // namespace

extern "C" {

// First-point-per-voxel downsample (pcp::voxelDownSampleV2 "keep first"
// semantics used for keyframe storage). Returns number of output points.
// out must have room for n points.
int64_t voxel_downsample_first(const float* xyz, int64_t n, float grid,
                               float* out) {
    KeySet set(static_cast<size_t>(n));
    const float inv = 1.0f / grid;
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = xyz + 3 * i;
        if (!std::isfinite(p[0]) || !std::isfinite(p[1]) || !std::isfinite(p[2]))
            continue;
        if (set.insert(voxel_key(p[0], p[1], p[2], inv))) {
            out[3 * m] = p[0];
            out[3 * m + 1] = p[1];
            out[3 * m + 2] = p[2];
            ++m;
        }
    }
    return m;
}

// Centroid-per-voxel downsample written straight into the fixed-capacity
// padded device layout (PCL VoxelGrid / pcp::voxelDownSampleV3 semantics:
// mean of up to max_pts points per voxel, first-seen voxel order). If more
// voxels than `capacity` survive, the output is stride-subsampled (uniform
// spatial thinning) instead of prefix-truncated — a prefix cut in voxel-key
// order would drop a contiguous spatial region. Rows beyond the valid count
// are filled with pad_coord. Returns the valid count.
int64_t voxel_downsample_centroid_pad(const float* xyz, int64_t n, float grid,
                                      int64_t max_pts, int64_t capacity,
                                      float pad_coord, float* out) {
    // Single open-addressing table with INLINE accumulators: one ~L2-resident
    // 32-byte entry per occupied voxel, so the per-point probe costs one
    // cache line instead of the three (slots / index / accumulator arrays) of
    // the previous layout. The table is sized to the OBSERVED voxel count
    // (a 0.5 m scan occupies ~n/3 voxels) and rehashes by doubling past 60 %
    // load — sizing to 2n up front put the working set at ~1.3 MB and made
    // the producer memory-latency bound (~335 ns/point measured; this layout
    // measures ~3.5x faster on the same scans).
    struct Entry {
        int64_t key;      // voxel key, valid when cnt > 0
        // float (not double) accumulators keep the entry at one 32-byte
        // cache line; safe because cnt <= max_pts bounds the sum to a few
        // tens of same-voxel (therefore similar-magnitude) coordinates —
        // callers raising max_pts past ~100 should widen these to double.
        float sx, sy, sz; // coordinate sum over the first <= max_pts points
        int32_t cnt;
        int32_t first;    // first-seen input index (output ordering)
        int32_t pad_;
    };
    size_t cap = 4096;
    std::vector<Entry> tab(cap);
    for (auto& e : tab) e.cnt = 0;
    size_t mask = cap - 1;
    size_t used = 0;
    const float inv = 1.0f / grid;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = xyz + 3 * i;
        if (!std::isfinite(p[0]) || !std::isfinite(p[1]) || !std::isfinite(p[2]))
            continue;
        const int64_t key = voxel_key(p[0], p[1], p[2], inv);
        size_t h = static_cast<size_t>(mix64(static_cast<uint64_t>(key))) & mask;
        while (tab[h].cnt && tab[h].key != key) h = (h + 1) & mask;
        Entry& e = tab[h];
        if (!e.cnt) {
            e.key = key;
            e.sx = p[0]; e.sy = p[1]; e.sz = p[2];
            e.cnt = 1;
            e.first = static_cast<int32_t>(i);
            if (++used * 5 > cap * 3) {  // rehash past 60% load
                std::vector<Entry> old;
                old.swap(tab);
                cap <<= 1;
                mask = cap - 1;
                tab.assign(cap, Entry{0, 0, 0, 0, 0, 0, 0});
                for (const auto& oe : old) {
                    if (!oe.cnt) continue;
                    size_t g = static_cast<size_t>(
                        mix64(static_cast<uint64_t>(oe.key))) & mask;
                    while (tab[g].cnt) g = (g + 1) & mask;
                    tab[g] = oe;
                }
                continue;  // `e` references the swapped-out table: dead here
            }
        } else if (e.cnt < max_pts) {
            e.sx += p[0]; e.sy += p[1]; e.sz += p[2];
            ++e.cnt;
        }
    }
    // first-seen output order: collect occupied entries, sort by first index
    std::vector<std::pair<int32_t, int32_t>> order;  // (first_idx, table slot)
    order.reserve(used);
    for (size_t h = 0; h < cap; ++h)
        if (tab[h].cnt)
            order.emplace_back(tab[h].first, static_cast<int32_t>(h));
    std::sort(order.begin(), order.end());
    const int64_t nv = static_cast<int64_t>(order.size());
    const int64_t m = nv <= capacity ? nv : capacity;
    for (int64_t k = 0; k < m; ++k) {
        // overflow: uniform stride subsample onto the capacity grid
        const int64_t v = nv <= capacity ? k : k * nv / capacity;
        const Entry& e = tab[order[v].second];
        const float ic = 1.0f / static_cast<float>(e.cnt);
        out[3 * k] = e.sx * ic;
        out[3 * k + 1] = e.sy * ic;
        out[3 * k + 2] = e.sz * ic;
    }
    for (int64_t i = m; i < capacity; ++i) {
        out[3 * i] = pad_coord;
        out[3 * i + 1] = pad_coord;
        out[3 * i + 2] = pad_coord;
    }
    return m;
}

// Batched form of the above: `n_scans` independent clouds concatenated in
// `xyz` with per-cloud sizes in `counts`, downsampled in parallel (OpenMP
// over scans — each scan's hash accumulate is sequential but scans are
// independent). One ctypes call per batch keeps the GIL released for the
// whole batch, so the Python producer thread stops serializing against the
// executor's bookkeeping (pipeline/streamed.py; the streamed hosts have few
// cores, so intra-call parallelism beats Python-thread parallelism).
// out: (n_scans, capacity, 3); out_counts: (n_scans). `threads` caps the
// OpenMP width — the caller leaves one core free for the thread that
// dispatches device work and fetches its results.
void voxel_downsample_centroid_pad_batch(
    const float* xyz, const int64_t* counts, int64_t n_scans, float grid,
    int64_t max_pts, int64_t capacity, float pad_coord, float* out,
    int64_t* out_counts, int64_t threads) {
    std::vector<int64_t> offs(n_scans + 1, 0);
    for (int64_t c = 0; c < n_scans; ++c) offs[c + 1] = offs[c] + counts[c];
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic) num_threads(static_cast<int>(threads))
#endif
    for (int64_t c = 0; c < n_scans; ++c) {
        out_counts[c] = voxel_downsample_centroid_pad(
            xyz + 3 * offs[c], counts[c], grid, max_pts, capacity, pad_coord,
            out + 3 * capacity * c);
    }
}

// Full producer prep in one call: downsample + spatial sort + int16
// quantization (the streamed executor's upload format). Sorting each
// scan's points by voxel key at `sort_grid` makes consecutive registration
// queries hit neighboring rows of the dense target in device memory;
// quantizing to round(x / quant_scale) int16 (pad sentinel 32767) halves
// the upload bytes. Doing all three here keeps the GIL released for the
// whole chunk, where the numpy equivalents would hold it.
void voxel_downsample_sort_quant_batch(
    const float* xyz, const int64_t* counts, int64_t n_scans, float grid,
    int64_t max_pts, int64_t capacity, float sort_grid, float quant_scale,
    int16_t* out, int64_t* out_counts, int64_t threads) {
    std::vector<int64_t> offs(n_scans + 1, 0);
    for (int64_t c = 0; c < n_scans; ++c) offs[c + 1] = offs[c] + counts[c];
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic) num_threads(static_cast<int>(threads))
#endif
    for (int64_t c = 0; c < n_scans; ++c) {
        std::vector<float> tmp(static_cast<size_t>(capacity) * 3);
        const int64_t m = voxel_downsample_centroid_pad(
            xyz + 3 * offs[c], counts[c], grid, max_pts, capacity, 0.0f,
            tmp.data());
        std::vector<int32_t> idx(m);
        for (int64_t i = 0; i < m; ++i) idx[i] = static_cast<int32_t>(i);
        if (sort_grid > 0.0f && m > 1) {
            std::vector<std::pair<int64_t, int32_t>> keys(m);
            const float inv = 1.0f / sort_grid;
            for (int64_t i = 0; i < m; ++i) {
                const int64_t kx =
                    static_cast<int64_t>(std::floor(tmp[3 * i] * inv)) +
                    (1 << 20);
                const int64_t ky =
                    static_cast<int64_t>(std::floor(tmp[3 * i + 1] * inv)) +
                    (1 << 20);
                const int64_t kz =
                    static_cast<int64_t>(std::floor(tmp[3 * i + 2] * inv)) +
                    (1 << 20);
                keys[i] = {(kx << 42) | (ky << 21) | kz,
                           static_cast<int32_t>(i)};
            }
            std::sort(keys.begin(), keys.end());
            for (int64_t i = 0; i < m; ++i) idx[i] = keys[i].second;
        }
        int16_t* o = out + 3 * capacity * c;
        const float qinv = 1.0f / quant_scale;
        int64_t w = 0;
        for (int64_t k = 0; k < m; ++k) {
            const float* p = tmp.data() + 3 * idx[k];
            // a return beyond the quantization range is DROPPED, not
            // clamped: clamping pinned phantom points to the +-125 m box
            // faces, which then entered registration and the keyframe map
            float q0 = std::nearbyint(p[0] * qinv);
            float q1 = std::nearbyint(p[1] * qinv);
            float q2 = std::nearbyint(p[2] * qinv);
            if (q0 > 32766.0f || q0 < -32766.0f || q1 > 32766.0f ||
                q1 < -32766.0f || q2 > 32766.0f || q2 < -32766.0f)
                continue;
            o[3 * w] = static_cast<int16_t>(q0);
            o[3 * w + 1] = static_cast<int16_t>(q1);
            o[3 * w + 2] = static_cast<int16_t>(q2);
            ++w;
        }
        for (int64_t k = w; k < capacity; ++k) {
            o[3 * k] = 32767;
            o[3 * k + 1] = 32767;
            o[3 * k + 2] = 32767;
        }
        out_counts[c] = w;
    }
}

// NaN-strip + pad/truncate into the fixed-capacity device layout:
// out (capacity,3) filled with pad_coord beyond the valid prefix,
// mask (capacity) bytes 0/1. Returns the valid count.
int64_t pad_cloud(const float* xyz, int64_t n, int64_t capacity,
                  float pad_coord, float* out, uint8_t* mask) {
    int64_t m = 0;
    for (int64_t i = 0; i < n && m < capacity; ++i) {
        const float* p = xyz + 3 * i;
        if (!std::isfinite(p[0]) || !std::isfinite(p[1]) || !std::isfinite(p[2]))
            continue;
        out[3 * m] = p[0];
        out[3 * m + 1] = p[1];
        out[3 * m + 2] = p[2];
        mask[m] = 1;
        ++m;
    }
    for (int64_t i = m; i < capacity; ++i) {
        out[3 * i] = pad_coord;
        out[3 * i + 1] = pad_coord;
        out[3 * i + 2] = pad_coord;
        mask[i] = 0;
    }
    return m;
}

// Submap assembly: transform each keyframe cloud by its 4x4 row-major pose
// and concatenate (MapManager::updateMap gather, MapManager.cpp:176-192).
// clouds: concatenated (sum(counts),3); counts: per-cloud sizes;
// poses: (k,16) row-major. out must have room for sum(counts) points.
// Returns total points written. OpenMP over clouds.
int64_t transform_concat(const float* clouds, const int64_t* counts,
                         const float* poses, int64_t k, float* out) {
    std::vector<int64_t> offs(k + 1, 0);
    for (int64_t c = 0; c < k; ++c) offs[c + 1] = offs[c] + counts[c];
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t c = 0; c < k; ++c) {
        const float* P = poses + 16 * c;
        const float* src = clouds + 3 * offs[c];
        float* dst = out + 3 * offs[c];
        const int64_t n = counts[c];
        for (int64_t i = 0; i < n; ++i) {
            const float x = src[3 * i], y = src[3 * i + 1], z = src[3 * i + 2];
            dst[3 * i] = P[0] * x + P[1] * y + P[2] * z + P[3];
            dst[3 * i + 1] = P[4] * x + P[5] * y + P[6] * z + P[7];
            dst[3 * i + 2] = P[8] * x + P[9] * y + P[10] * z + P[11];
        }
    }
    return offs[k];
}

}  // extern "C"
