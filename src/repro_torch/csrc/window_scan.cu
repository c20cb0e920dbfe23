// Blocked segmented windowed scan for Hopper.
//
// Replaces the TPU kernel windowed_scan_pallas
// (src/repro/kernels/window_scan/kernel.py).  For values (n, L) float32
// (rows `ld` floats apart, lanes adjacent) and seg_start (n,) int32 it
// computes, for op in sum / min / max,
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
// prefix[i].  Each chunk runs the reference's Hillis–Steele ladder (same
// steps, same operand order, same identity fills), so for w <= kTile the
// sums are bit-identical to the plain version.
//
// Bound: memory.  The function reads values and seg_start once and writes
// out once (0.200 ms of bytes at the main path's (2^25 - 3, 2) float32 on
// an H100), so for w <= kTile the design keeps everything else on chip in
// one pass:
//
//   * w <= 32 (window_scan_warp, the main path's rows=32): a warp holds
//     32 / w whole chunks, one row a thread, and runs both ladders with
//     __shfl_up_sync / __shfl_down_sync, no shared memory and no
//     __syncthreads.  Each warp walks a run of consecutive 32-row steps,
//     keeps the previous step's suffixes in registers for the cross-chunk
//     combine, and recomputes only the one step before its run (under 1%
//     of the rows at the main path's size); the grid is one full wave of
//     resident warps.  The segment flags do not depend on the values: a
//     ballot of segment starts gives each row, in closed form, how many
//     ladder steps it takes before its flag is set, once for all lanes.
//     What remains is instruction issue, not bytes: one and two lanes
//     take the same time (0.43 ms against 0.200 ms of bytes on an H100
//     80GB HBM3 at 700 W, scripts/kernels_before_after.py).
//   * 32 < w <= kTile (window_scan_block): one CTA a tile of whole chunks,
//     all lanes; its suffix ladder runs one chunk behind the tile, over
//     the chunk before it, whose suffixes it recomputes instead of reading
//     them from scratch memory; ladders in shared memory.
//   * w > kTile: a chunk spans several tiles and three passes remain:
//     window_scan_local (ladders per tile and lane into pre / suf
//     scratch), window_scan_carry (one thread per (chunk, lane) walks the
//     tiles' carries) and window_scan_combine.  Sums then add in another
//     order than the plain version's and agree to a tolerance.
//
// Values are read through their row stride, so the window engine's
// strided column views go in without a copy.
//
// min / max propagate NaN and order -0.0 below +0.0, as jnp.minimum /
// jnp.maximum and the plain version do; fminf / fmaxf would drop NaN.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 4;  // rows of a tile per thread
constexpr int kTile = kThreads * kRows;
constexpr unsigned kFull = 0xffffffffu;

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

struct Scan {
    const float* values;
    int64_t ld;  // floats between rows of values
    const int32_t* seg;
    int64_t n;
    int lanes;
    int64_t w;
    float* out;  // (n, lanes), contiguous
};

// ---------------------------------------------------------------------------
// w <= 32: one warp, 32 / w chunks a step, shuffles only
// ---------------------------------------------------------------------------
constexpr int kWarpLevels = 5;  // ladder steps d = 1 .. 16 of a 32-row chunk

template <int OP, int NL>  // NL: value lanes a warp holds at once
__global__ void __launch_bounds__(256)
window_scan_warp(Scan p, int64_t n_steps, int64_t run) {
    const int t = threadIdx.x & 31;
    const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x
                          + threadIdx.x) >> 5;
    const int64_t s0 = warp * run;
    if (s0 >= n_steps) return;
    const int64_t s1 = min(s0 + run, n_steps);
    const int w = static_cast<int>(p.w);
    const int R = (32 / w) * w;  // rows of a step: whole chunks
    const int o = t % w;         // row offset inside its chunk
    const bool last_chunk = t >= R - w;
    const int64_t first = s0 > 0 ? s0 - 1 : s0;  // the step before the run

    for (int l0 = 0; l0 < p.lanes; l0 += NL) {
        const int nl = min(NL, p.lanes - l0);
        float x[NL], nx[NL], prev[NL];
        int32_t sj = 0, nsj = 0;
        auto load = [&](int64_t s, float* v, int32_t& sg) {
            const int64_t j = s * R + t;
            const bool real = t < R && j < p.n;
            sg = real ? p.seg[j] : 0;
            const float* row = p.values + j * p.ld + l0;
#pragma unroll
            for (int q = 0; q < NL; ++q) {
                v[q] = (real && q < nl) ? row[q] : identity<OP>();
            }
        };
#pragma unroll
        for (int q = 0; q < NL; ++q) prev[q] = nx[q] = identity<OP>();
        load(first, x, sj);
        for (int64_t s = first; s < s1; ++s) {
            if (s + 1 < s1) load(s + 1, nx, nsj);  // next step in flight
            const int64_t j = s * R + t;
            const bool real = t < R && j < p.n;
            // Segment flags (padding rows and idle lanes start their own;
            // a row's suffix flag is "the next row starts a segment").  The
            // ladder's flag before step k (d = 2^k) is closed form: the
            // prefix flag is set once 2^k - 1 >= min(o + 1, distance back to
            // the row's segment start), the suffix flag once 2^k - 1 >=
            // min(w - o, distance on to the next row that is followed by a
            // start), so each ladder runs its first `kp` / `ks` steps and
            // stops.  One ballot each gives every lane's distances.
            const unsigned starts = __ballot_sync(kFull, !real || sj == j);
            const bool g0 = t < 31 && o + 1 < w && ((starts >> (t + 1)) & 1u);
            const unsigned gs = __ballot_sync(kFull, g0);
            const unsigned back = starts & (kFull >> (31 - t));  // lanes <= t
            const int dist = back ? t - (31 - __clz(back)) : 32;
            const unsigned on = gs >> t;  // lanes >= t
            const int gdist = on ? __ffs(on) - 1 : 32;
            const int kp = 32 - __clz(min(o + 1, dist));
            const int ks = 32 - __clz(min(w - o, gdist));
            // Publish for the cross-chunk combine: a row of the step's last
            // chunk is read only by the next step's first chunk (its
            // previous step's suffix), any other row only by the next
            // chunk of this step.
            float pre[NL], pub[NL];
#pragma unroll
            for (int q = 0; q < NL; ++q) {
                float v = x[q], u = x[q];
#pragma unroll
                for (int k = 0; k < kWarpLevels; ++k) {
                    const int d = 1 << k;
                    if (d >= w) break;
                    const float sv = __shfl_up_sync(kFull, v, d);
                    const float su = __shfl_down_sync(kFull, u, d);
                    if (k < kp) {
                        v = combine<OP>(o >= d ? sv : identity<OP>(), v);
                    }
                    if (k < ks) {
                        u = combine<OP>(o + d < w ? su : identity<OP>(), u);
                    }
                }
                pre[q] = v;
                pub[q] = last_chunk ? prev[q] : u;
                prev[q] = u;
                x[q] = nx[q];
            }
            if (s >= s0) {
                // a window that starts in the previous chunk: that chunk's
                // suffix at a, from this step or the one before
                const int64_t base = s * R;
                const int64_t a = max(j - w + 1, static_cast<int64_t>(sj));
                const bool straddle = real && a < j - o;
                const int src = straddle
                    ? static_cast<int>(a >= base ? a - base : a - base + R)
                    : t;
                float* dst = p.out + j * p.lanes + l0;
#pragma unroll
                for (int q = 0; q < NL; ++q) {
                    const float sa = __shfl_sync(kFull, pub[q], src);
                    const float r = straddle ? combine<OP>(sa, pre[q]) : pre[q];
                    if (real && q < nl) dst[q] = r;
                }
            }
            sj = nsj;
        }
    }
}

// ---------------------------------------------------------------------------
// 32 < w <= kTile: one CTA a tile of whole chunks.  The suffix ladder runs
// over the tile's chunks but its last, shifted back by one chunk so that it
// covers the lead-in chunk before the tile (whose suffixes the tile's first
// chunk reads); the prefix ladder runs over the tile.  Both fit kTile rows.
// ---------------------------------------------------------------------------
template <int OP>
__global__ void __launch_bounds__(kThreads)
window_scan_block(Scan p, int64_t tile_rows) {
    __shared__ float sv[kTile];  // ladder exchange
    __shared__ float su[kTile];  // suffixes for the combine
    __shared__ unsigned char sf[kTile];
    const int64_t w = p.w;
    const int span = static_cast<int>(w);
    const int rows = static_cast<int>(tile_rows);
    const int64_t r0 = blockIdx.x * tile_rows;
    const int64_t e0 = r0 > 0 ? r0 - w : 0;  // the suffix ladder's first row
    const int slen = static_cast<int>(r0 + tile_rows - w - e0);

    int o[kRows];  // offset of each row inside its chunk (e0, r0: chunk starts)
#pragma unroll
    for (int q = 0; q < kRows; ++q) o[q] = (threadIdx.x + q * kThreads) % span;
    for (int lane = 0; lane < p.lanes; ++lane) {
        float v[kRows];
        unsigned f = 0;  // bit q: row q's flag
        auto load = [&](int64_t j) {
            return j < p.n ? p.values[j * p.ld + lane] : identity<OP>();
        };

        // suffix: at offset d an open row combines with the row d to its
        // right (the later span is the left operand); a row's flag is "the
        // next row starts a segment" (false at the chunk's last row)
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
            const int c = threadIdx.x + q * kThreads;
            v[q] = load(e0 + c);
            const bool flag = c >= slen
                || (o[q] + 1 < span && starts_segment(p.seg, e0 + c + 1, p.n));
            f |= static_cast<unsigned>(flag) << q;
        }
        for (int d = 1; d < span; d <<= 1) {
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
                const int c = threadIdx.x + q * kThreads;
                sv[c] = v[q];
                sf[c] = (f >> q) & 1u;
            }
            __syncthreads();
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
                if ((f >> q) & 1u) continue;
                const int c = threadIdx.x + q * kThreads;
                if (o[q] + d < span) {
                    v[q] = combine<OP>(sv[c + d], v[q]);
                    f |= static_cast<unsigned>(sf[c + d]) << q;
                } else {
                    v[q] = combine<OP>(identity<OP>(), v[q]);
                    f |= 1u << q;
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) su[threadIdx.x + q * kThreads] = v[q];

        // prefix over the tile: the mirror image
        f = 0;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
            const int c = threadIdx.x + q * kThreads;
            v[q] = load(r0 + c);
            const bool flag = c >= rows || starts_segment(p.seg, r0 + c, p.n);
            f |= static_cast<unsigned>(flag) << q;
        }
        for (int d = 1; d < span; d <<= 1) {
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
                const int c = threadIdx.x + q * kThreads;
                sv[c] = v[q];
                sf[c] = (f >> q) & 1u;
            }
            __syncthreads();
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
                if ((f >> q) & 1u) continue;
                const int c = threadIdx.x + q * kThreads;
                if (o[q] >= d) {
                    v[q] = combine<OP>(sv[c - d], v[q]);
                    f |= static_cast<unsigned>(sf[c - d]) << q;
                } else {
                    v[q] = combine<OP>(identity<OP>(), v[q]);
                    f |= 1u << q;
                }
            }
            __syncthreads();
        }

        // the one cross-chunk combine: suffix[a] ⊕ prefix[i]
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
            const int c = threadIdx.x + q * kThreads;
            const int64_t j = r0 + c;
            if (c >= rows || j >= p.n) continue;
            const int64_t a = max(j - w + 1, static_cast<int64_t>(p.seg[j]));
            float r = v[q];
            if (a < j - o[q]) r = combine<OP>(su[a - e0], r);
            p.out[j * p.lanes + lane] = r;
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// w > kTile: chunk c is cut into k_tiles tiles of kTile rows
// ---------------------------------------------------------------------------
__device__ __forceinline__ void carry_tile(int64_t t, int64_t w,
                                           int64_t k_tiles, int64_t& r0,
                                           int64_t& r1) {
    const int64_t c = t / k_tiles, k = t - c * k_tiles;
    r0 = c * w + k * kTile;
    r1 = min(r0 + static_cast<int64_t>(kTile), (c + 1) * w);
}

// Pass 1: segmented prefix and suffix ladders over each tile's rows.
template <int OP>
__global__ void __launch_bounds__(kThreads)
window_scan_local(Scan p, int64_t k_tiles, float* __restrict__ pre,
                  float* __restrict__ suf) {
    __shared__ float sv[kTile];
    __shared__ unsigned char sf[kTile];
    const int lane = blockIdx.y;
    int64_t r0, r1;
    carry_tile(blockIdx.x, p.w, k_tiles, r0, r1);
    if (r0 >= p.n) return;  // all padding: nothing to write

    float v[kRows];
    bool f[kRows];
    int hi[kRows];  // region end, relative to r0
    float x[kRows];
    for (int q = 0; q < kRows; ++q) {
        const int64_t j = r0 + threadIdx.x + q * kThreads;
        const int64_t cs = (j / p.w) * p.w;
        hi[q] = static_cast<int>(min(cs + p.w, r1) - r0);
        const bool real = j < r1 && j < p.n;
        x[q] = real ? p.values[j * p.ld + lane] : identity<OP>();
    }

    // prefix (a tile starts at or after its chunk's start)
    for (int q = 0; q < kRows; ++q) {
        v[q] = x[q];
        f[q] = starts_segment(p.seg, r0 + threadIdx.x + q * kThreads, p.n);
    }
    for (int d = 1; d < kTile; d <<= 1) {
        for (int q = 0; q < kRows; ++q) {
            const int c = threadIdx.x + q * kThreads;
            sv[c] = v[q];
            sf[c] = f[q];
        }
        __syncthreads();
        for (int q = 0; q < kRows; ++q) {
            if (f[q]) continue;
            const int c = threadIdx.x + q * kThreads - d;
            if (c >= 0) {
                v[q] = combine<OP>(sv[c], v[q]);
                f[q] = sf[c];
            } else {
                v[q] = combine<OP>(identity<OP>(), v[q]);
                f[q] = true;
            }
        }
        __syncthreads();
    }
    for (int q = 0; q < kRows; ++q) {
        const int64_t j = r0 + threadIdx.x + q * kThreads;
        if (j < r1 && j < p.n) pre[j * p.lanes + lane] = v[q];
    }

    // suffix
    for (int q = 0; q < kRows; ++q) {
        const int64_t j = r0 + threadIdx.x + q * kThreads;
        v[q] = x[q];
        const int64_t cs = (j / p.w) * p.w;
        f[q] = j + 1 < cs + p.w && starts_segment(p.seg, j + 1, p.n);
    }
    for (int d = 1; d < kTile; d <<= 1) {
        for (int q = 0; q < kRows; ++q) {
            const int c = threadIdx.x + q * kThreads;
            sv[c] = v[q];
            sf[c] = f[q];
        }
        __syncthreads();
        for (int q = 0; q < kRows; ++q) {
            if (f[q]) continue;
            const int c = threadIdx.x + q * kThreads + d;
            if (c < hi[q]) {
                v[q] = combine<OP>(sv[c], v[q]);
                f[q] = sf[c];
            } else {
                v[q] = combine<OP>(identity<OP>(), v[q]);
                f[q] = true;
            }
        }
        __syncthreads();
    }
    for (int q = 0; q < kRows; ++q) {
        const int64_t j = r0 + threadIdx.x + q * kThreads;
        if (j < r1 && j < p.n) suf[j * p.lanes + lane] = v[q];
    }
}

// Pass 2: per (chunk, lane), the prefix carried into each tile (the full
// prefix at the row before it) and the suffix carried out of each tile's
// end (the full suffix at the next tile's first row).
template <int OP>
__global__ void window_scan_carry(Scan p, int64_t k_tiles, int64_t chunks,
                                  const float* __restrict__ pre,
                                  const float* __restrict__ suf,
                                  float* __restrict__ carry_pre,
                                  float* __restrict__ carry_suf) {
    const int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
    const int lanes = p.lanes;
    if (id >= chunks * lanes) return;
    const int64_t c = id / lanes;
    const int lane = static_cast<int>(id - c * lanes);
    const int64_t base = c * p.w, K = k_tiles;
    float* cp = carry_pre + c * K * lanes + lane;
    float* cq = carry_suf + c * K * lanes + lane;

    float run = identity<OP>();
    cp[0] = run;
    for (int64_t k = 1; k < K; ++k) {
        const int64_t last = base + k * kTile - 1;  // last row of tile k-1
        if (last < p.n) {
            const float local = pre[last * lanes + lane];
            const bool opened = k - 1 == 0
                || p.seg[last] >= base + (k - 1) * kTile;
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
        if (e < p.n) {
            const float local = suf[e * lanes + lane];
            const int64_t e2 = min(base + (k + 2) * kTile, base + p.w);
            const bool cont = k + 1 < K - 1 && e2 < p.n && p.seg[e2] == p.seg[e];
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
__global__ void window_scan_combine(Scan p, int64_t k_tiles,
                                    const float* __restrict__ pre,
                                    const float* __restrict__ suf,
                                    const float* __restrict__ carry_pre,
                                    const float* __restrict__ carry_suf) {
    const int lanes = p.lanes;
    const int64_t total = p.n * lanes;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t K = k_tiles, w = p.w;
    for (int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
         id < total; id += stride) {
        const int64_t i = id / lanes;
        const int lane = static_cast<int>(id - i * lanes);
        const int64_t c = i / w, cs = c * w;
        const int64_t si = p.seg[i];
        float v = pre[id];
        const int64_t k = (i - cs) / kTile;
        if (k > 0 && si < cs + k * kTile) {
            v = combine<OP>(carry_pre[(c * K + k) * lanes + lane], v);
        }
        const int64_t a = max(i - w + 1, si);
        if (a < cs) {
            float s = suf[a * lanes + lane];
            const int64_t ca = a / w, csa = ca * w;
            const int64_t ka = (a - csa) / kTile;
            const int64_t r1 = min(csa + (ka + 1) * kTile, csa + w);
            if (r1 < csa + w && r1 < p.n && p.seg[r1] == p.seg[a]) {
                s = combine<OP>(carry_suf[(ca * K + ka) * lanes + lane], s);
            }
            v = combine<OP>(s, v);
        }
        p.out[id] = v;
    }
}

// Warps of window_scan_warp<OP, NL> the current device holds at once
// (SMs x resident CTAs an SM x warps a CTA), asked once per device.
template <int OP, int NL>
cudaError_t resident_warps(int threads, int64_t* warps) {
    constexpr int kDevices = 64;
    static std::atomic<int64_t> known[kDevices];  // 0: not asked yet
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && (*warps = known[dev].load()) > 0) return cudaSuccess;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_scan_warp<OP, NL>, threads, 0);
    if (err != cudaSuccess) return err;
    if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
    *warps = static_cast<int64_t>(sms) * per_sm * (threads / 32);
    if (dev < kDevices) known[dev].store(*warps);
    return cudaSuccess;
}

// w <= 32: as many warps as fit the card at once, each a run of equal
// length, so no SM waits on a second wave; the run is at least 16 steps
// (the recomputed step costs under 1/16 of a run; under 1% at the main
// path's size).
template <int OP, int NL>
int launch_warp(const Scan& p, cudaStream_t s) {
    constexpr int threads = 256;
    const int64_t rows = (32 / p.w) * p.w;
    const int64_t steps = (p.n + rows - 1) / rows;
    int64_t resident = 0;
    const cudaError_t err = resident_warps<OP, NL>(threads, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t run = max(static_cast<int64_t>(16),
                            (steps + resident - 1) / resident);
    const int64_t warps = (steps + run - 1) / run;
    window_scan_warp<OP, NL><<<static_cast<unsigned>(
                                   (warps * 32 + threads - 1) / threads),
                               threads, 0, s>>>(p, steps, run);
    return static_cast<int>(cudaGetLastError());
}

template <int OP>
int launch(const Scan& p, float* pre, float* suf, float* carry_pre,
           float* carry_suf, cudaStream_t s) {
    if (p.w <= 32) {
        if (p.lanes == 1) return launch_warp<OP, 1>(p, s);
        if (p.lanes == 2) return launch_warp<OP, 2>(p, s);
        return launch_warp<OP, 4>(p, s);
    }
    if (p.w <= kTile) {
        const int64_t tile_rows = (kTile / p.w) * p.w;
        window_scan_block<OP><<<static_cast<unsigned>((p.n + tile_rows - 1)
                                                      / tile_rows),
                                kThreads, 0, s>>>(p, tile_rows);
        return static_cast<int>(cudaGetLastError());
    }
    const int64_t k_tiles = (p.w + kTile - 1) / kTile;
    const int64_t chunks = (p.n + p.w - 1) / p.w;
    window_scan_local<OP><<<dim3(static_cast<unsigned>(chunks * k_tiles),
                                 p.lanes),
                            kThreads, 0, s>>>(p, k_tiles, pre, suf);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int threads = 128;
    const int64_t work = chunks * p.lanes;
    window_scan_carry<OP><<<static_cast<unsigned>((work + threads - 1)
                                                  / threads),
                            threads, 0, s>>>(p, k_tiles, chunks, pre, suf,
                                             carry_pre, carry_suf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    window_scan_combine<OP><<<hptmt::grid_for(p.n * p.lanes, 256), 256, 0,
                              s>>>(p, k_tiles, pre, suf, carry_pre,
                                   carry_suf);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values (n, lanes) float32 with rows ld floats apart and unit lane
// stride, seg_start (n,) int32 → out (n, lanes) contiguous.  Only when
// window > tile: pre and suf are (n, lanes) float32 scratch, and
// carry_pre and carry_suf hold ceil(n / w) * ceil(w / tile) * lanes
// floats each (all four unused, and may be null, otherwise).  `tile` must
// equal this file's kTile: the wrapper sizes the scratch with it.
HPTMT_API int hptmt_windowed_scan(const void* values, int64_t ld,
                                  const void* seg, int64_t n, int lanes,
                                  int64_t window, int op, int tile, void* pre,
                                  void* suf, void* carry_pre, void* carry_suf,
                                  void* out, void* stream) {
    if (tile != kTile || window < 1 || lanes < 1 || lanes > 65535 || ld < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n <= 0) return static_cast<int>(cudaSuccess);
    const Scan p{static_cast<const float*>(values), ld,
                 static_cast<const int32_t*>(seg), n, lanes, window,
                 static_cast<float*>(out)};
    float* q = static_cast<float*>(pre);
    float* r = static_cast<float*>(suf);
    float* cp = static_cast<float*>(carry_pre);
    float* cq = static_cast<float*>(carry_suf);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (op) {
        case 0: return launch<0>(p, q, r, cp, cq, s);
        case 1: return launch<1>(p, q, r, cp, cq, s);
        case 2: return launch<2>(p, q, r, cp, cq, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
