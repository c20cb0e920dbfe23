// Blocked segmented windowed scan for Hopper.
//
// Replaces the TPU kernel windowed_scan_pallas
// (src/repro/kernels/window_scan/kernel.py).  For values (n, L) float32
// and seg_start (n,) int32 it computes, for op in sum / min / max,
//
//     out[i] = op(values[a .. i]),   a = max(i - w + 1, seg_start[i]),
//
// the trailing w-row window clipped at the row's segment (partition)
// start.  seg_start[i] <= i and is constant within a segment, segments
// being contiguous (the window engine derives it from sorted keys).
//
// Algorithm: the reference's two-scan decomposition.  Rows split into
// chunks of exactly w rows (padding rows past n hold the identity and are
// their own segments); a segmented prefix scan runs forward and a
// segmented suffix scan backward inside each chunk, and a window that
// straddles a chunk boundary is suffix[a] (previous chunk) combined with
// prefix[i].  The TPU kernel loads each block and its predecessor into
// VMEM with two BlockSpecs; here the work splits into three passes:
//
//   1. window_scan_local: one CTA per (tile, lane).  A tile is a run of
//      kTile = 4096 rows held in shared memory.  For w <= kTile it holds
//      whole chunks, and each chunk runs the reference's Hillis–Steele
//      ladder (same steps, same operand order, same identity fills), so
//      sums are bit-identical to the plain version.  For w > kTile a
//      chunk spans several tiles; each tile runs the ladder over its own
//      rows and leaves the rest to a carry.
//   2. window_scan_carry (only when w > kTile): one thread per
//      (chunk, lane) walks the chunk's tiles in order (prefix) and in
//      reverse (suffix) and records each tile's carry-in.  Sums then add
//      in another order than the plain version's and agree to a
//      tolerance; min and max stay exact.
//   3. window_scan_combine: one thread per (row, lane) applies the
//      carries and the one cross-chunk combine.
//
// Bound: memory.  The function reads values and seg_start once and writes
// out once; this design also writes and rereads the prefix and suffix
// scratch (about 3x the bytes of the bound).  Fusing passes 1 and 3 (a
// CTA that also rescans the previous chunk's suffix) is the next step.
//
// min / max propagate NaN and order -0.0 below +0.0, as jnp.minimum /
// jnp.maximum and the plain version do; fminf / fmaxf would drop NaN.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 4;  // rows of a tile per thread
constexpr int kTile = kThreads * kRows;

template <int OP>  // 0 sum, 1 min, 2 max
__device__ __forceinline__ float identity() {
    return OP == 0 ? 0.0f : (OP == 1 ? __int_as_float(0x7f800000)
                                     : __int_as_float(0xff800000));
}

// a ⊕ b with the plain version's rules: a NaN operand wins (a first),
// and -0.0 < +0.0.
template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
    if (OP == 0) return __fadd_rn(a, b);
    bool take_a;
    if (OP == 1) {
        take_a = (a < b) || (a == b && signbit(a));
    } else {
        take_a = (a > b) || (a == b && !signbit(a));
    }
    return (take_a || isnan(a)) ? a : b;
}

__device__ __forceinline__ bool starts_segment(const int32_t* seg, int64_t j,
                                               int64_t n) {
    return j >= n || static_cast<int64_t>(seg[j]) == j;
}

// Tile t → rows [r0, r1).  With w <= kTile a tile holds `per` whole
// chunks; otherwise chunk c is cut into k_tiles tiles of kTile rows.
struct Geometry {
    int64_t n, w, k_tiles, per;

    __device__ __forceinline__ void tile(int64_t t, int64_t& r0,
                                         int64_t& r1) const {
        if (k_tiles == 1) {
            r0 = t * per * w;
            r1 = r0 + per * w;
        } else {
            const int64_t c = t / k_tiles, k = t - c * k_tiles;
            r0 = c * w + k * kTile;
            r1 = min(r0 + static_cast<int64_t>(kTile), (c + 1) * w);
        }
    }
};

// Pass 1: segmented prefix and suffix ladders over each tile's rows, each
// clipped to [max(chunk start, r0), min(chunk end, r1)).
template <int OP>
__global__ void __launch_bounds__(kThreads)
window_scan_local(const float* __restrict__ values,
                  const int32_t* __restrict__ seg, Geometry g, int lanes,
                  float* __restrict__ pre, float* __restrict__ suf) {
    __shared__ float sv[kTile];
    __shared__ unsigned char sf[kTile];
    const int lane = blockIdx.y;
    int64_t r0, r1;
    g.tile(blockIdx.x, r0, r1);
    if (r0 >= g.n) return;  // all padding: nothing to write
    const int64_t span = min(g.w, static_cast<int64_t>(kTile));

    float v[kRows];
    bool f[kRows];
    int lo[kRows], hi[kRows];  // region bounds, relative to r0
    float x[kRows];
    for (int q = 0; q < kRows; ++q) {
        const int p = threadIdx.x + q * kThreads;
        const int64_t j = r0 + p;
        const int64_t cs = (j / g.w) * g.w;
        lo[q] = static_cast<int>(max(cs, r0) - r0);
        hi[q] = static_cast<int>(min(cs + g.w, r1) - r0);
        const bool real = j < r1 && j < g.n;
        x[q] = real ? values[j * lanes + lane] : identity<OP>();
    }

    // prefix: at offset d an open row combines with the row d to its left
    for (int q = 0; q < kRows; ++q) {
        const int64_t j = r0 + threadIdx.x + q * kThreads;
        v[q] = x[q];
        f[q] = starts_segment(seg, j, g.n);
    }
    for (int64_t d = 1; d < span; d <<= 1) {
        for (int q = 0; q < kRows; ++q) {
            const int p = threadIdx.x + q * kThreads;
            sv[p] = v[q];
            sf[p] = f[q];
        }
        __syncthreads();
        for (int q = 0; q < kRows; ++q) {
            if (f[q]) continue;
            const int pp = threadIdx.x + q * kThreads - static_cast<int>(d);
            if (pp >= lo[q]) {
                v[q] = combine<OP>(sv[pp], v[q]);
                f[q] = sf[pp];
            } else {
                v[q] = combine<OP>(identity<OP>(), v[q]);
                f[q] = true;
            }
        }
        __syncthreads();
    }
    for (int q = 0; q < kRows; ++q) {
        const int64_t j = r0 + threadIdx.x + q * kThreads;
        if (j < r1 && j < g.n) pre[j * lanes + lane] = v[q];
    }

    // suffix: the mirror image; a row's flag is "the next row starts a
    // segment" (false at the chunk's last row), the left operand the
    // later span
    for (int q = 0; q < kRows; ++q) {
        const int p = threadIdx.x + q * kThreads;
        const int64_t j = r0 + p;
        v[q] = x[q];
        const int64_t cs = (j / g.w) * g.w;
        f[q] = j + 1 < cs + g.w && starts_segment(seg, j + 1, g.n);
    }
    for (int64_t d = 1; d < span; d <<= 1) {
        for (int q = 0; q < kRows; ++q) {
            const int p = threadIdx.x + q * kThreads;
            sv[p] = v[q];
            sf[p] = f[q];
        }
        __syncthreads();
        for (int q = 0; q < kRows; ++q) {
            if (f[q]) continue;
            const int pp = threadIdx.x + q * kThreads + static_cast<int>(d);
            if (pp < hi[q]) {
                v[q] = combine<OP>(sv[pp], v[q]);
                f[q] = sf[pp];
            } else {
                v[q] = combine<OP>(identity<OP>(), v[q]);
                f[q] = true;
            }
        }
        __syncthreads();
    }
    for (int q = 0; q < kRows; ++q) {
        const int64_t j = r0 + threadIdx.x + q * kThreads;
        if (j < r1 && j < g.n) suf[j * lanes + lane] = v[q];
    }
}

// Pass 2 (w > kTile): per (chunk, lane), the prefix carried into each
// tile (the full prefix at the row before it) and the suffix carried out
// of each tile's end (the full suffix at the next tile's first row).
template <int OP>
__global__ void window_scan_carry(const int32_t* __restrict__ seg,
                                  Geometry g, int lanes, int64_t chunks,
                                  const float* __restrict__ pre,
                                  const float* __restrict__ suf,
                                  float* __restrict__ carry_pre,
                                  float* __restrict__ carry_suf) {
    const int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
    if (id >= chunks * lanes) return;
    const int64_t c = id / lanes;
    const int lane = static_cast<int>(id - c * lanes);
    const int64_t base = c * g.w, K = g.k_tiles;
    float* cp = carry_pre + c * K * lanes + lane;
    float* cq = carry_suf + c * K * lanes + lane;

    float run = identity<OP>();
    cp[0] = run;
    for (int64_t k = 1; k < K; ++k) {
        const int64_t last = base + k * kTile - 1;  // last row of tile k-1
        if (last < g.n) {
            const float local = pre[last * lanes + lane];
            const bool opened = k - 1 == 0
                || seg[last] >= base + (k - 1) * kTile;
            run = opened ? local : combine<OP>(run, local);
        } else {
            run = identity<OP>();
        }
        cp[k * lanes] = run;
    }

    run = identity<OP>();
    cq[(K - 1) * lanes] = run;
    for (int64_t k = K - 2; k >= 0; --k) {
        const int64_t e = base + (k + 1) * kTile;  // first row of tile k+1
        if (e < g.n) {
            const float local = suf[e * lanes + lane];
            const int64_t e2 = min(base + (k + 2) * kTile, base + g.w);
            const bool cont = k + 1 < K - 1 && e2 < g.n && seg[e2] == seg[e];
            run = cont ? combine<OP>(run, local) : local;
        } else {
            run = identity<OP>();
        }
        cq[k * lanes] = run;
    }
}

// Pass 3: out[i] = prefix[i], or suffix[a] ⊕ prefix[i] when the window
// start a lies in the previous chunk; carries applied where a tile's scan
// stopped short of its segment.
template <int OP>
__global__ void window_scan_combine(const int32_t* __restrict__ seg,
                                    Geometry g, int lanes,
                                    const float* __restrict__ pre,
                                    const float* __restrict__ suf,
                                    const float* __restrict__ carry_pre,
                                    const float* __restrict__ carry_suf,
                                    float* __restrict__ out) {
    const int64_t total = g.n * lanes;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t K = g.k_tiles;
    for (int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
         id < total; id += stride) {
        const int64_t i = id / lanes;
        const int lane = static_cast<int>(id - i * lanes);
        const int64_t c = i / g.w, cs = c * g.w;
        const int64_t si = seg[i];
        float p = pre[id];
        if (K > 1) {
            const int64_t k = (i - cs) / kTile;
            if (k > 0 && si < cs + k * kTile) {
                p = combine<OP>(carry_pre[(c * K + k) * lanes + lane], p);
            }
        }
        const int64_t a = max(i - g.w + 1, si);
        if (a < cs) {
            float s = suf[a * lanes + lane];
            if (K > 1) {
                const int64_t ca = a / g.w, csa = ca * g.w;
                const int64_t ka = (a - csa) / kTile;
                const int64_t r1 = min(csa + (ka + 1) * kTile, csa + g.w);
                if (r1 < csa + g.w && r1 < g.n && seg[r1] == seg[a]) {
                    s = combine<OP>(carry_suf[(ca * K + ka) * lanes + lane],
                                    s);
                }
            }
            p = combine<OP>(s, p);
        }
        out[id] = p;
    }
}

template <int OP>
int launch(const float* values, const int32_t* seg, Geometry g, int lanes,
           float* pre, float* suf, float* carry_pre, float* carry_suf,
           float* out, cudaStream_t s) {
    const int64_t chunks = (g.n + g.w - 1) / g.w;
    const int64_t tiles = g.k_tiles == 1
        ? (chunks + g.per - 1) / g.per : chunks * g.k_tiles;
    window_scan_local<OP><<<dim3(static_cast<unsigned>(tiles), lanes),
                            kThreads, 0, s>>>(values, seg, g, lanes, pre,
                                              suf);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (g.k_tiles > 1) {
        constexpr int threads = 128;
        const int64_t work = chunks * lanes;
        window_scan_carry<OP><<<static_cast<unsigned>(
                                    (work + threads - 1) / threads),
                                threads, 0, s>>>(seg, g, lanes, chunks, pre,
                                                 suf, carry_pre, carry_suf);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    constexpr int threads = 256;
    window_scan_combine<OP><<<hptmt::grid_for(g.n * lanes, threads), threads,
                              0, s>>>(seg, g, lanes, pre, suf, carry_pre,
                                      carry_suf, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values (n, lanes) float32 and seg_start (n,) int32 → out (n, lanes).
// pre and suf are (n, lanes) float32 scratch; carry_pre and carry_suf
// hold ceil(n / w) * ceil(w / tile) * lanes floats each when w > tile
// (unused otherwise).  `tile` must equal this file's kTile: the wrapper
// sizes the carries with it.
HPTMT_API int hptmt_windowed_scan(const void* values, const void* seg,
                                  int64_t n, int lanes, int64_t window,
                                  int op, int tile, void* pre, void* suf,
                                  void* carry_pre, void* carry_suf,
                                  void* out, void* stream) {
    if (tile != kTile || window < 1 || lanes < 1 || lanes > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n <= 0) return static_cast<int>(cudaSuccess);
    Geometry g{n, window, window <= kTile ? 1 : (window + kTile - 1) / kTile,
               window <= kTile ? kTile / window : 1};
    const float* v = static_cast<const float*>(values);
    const int32_t* sg = static_cast<const int32_t*>(seg);
    float* p = static_cast<float*>(pre);
    float* q = static_cast<float*>(suf);
    float* cp = static_cast<float*>(carry_pre);
    float* cq = static_cast<float*>(carry_suf);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (op) {
        case 0: return launch<0>(v, sg, g, lanes, p, q, cp, cq, o, s);
        case 1: return launch<1>(v, sg, g, lanes, p, q, cp, cq, o, s);
        case 2: return launch<2>(v, sg, g, lanes, p, q, cp, cq, o, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
