// Segment reductions of the groupby for Hopper.
//
// Replaces two TPU kernels of src/repro/kernels/segment_reduce/kernel.py:
//   * segment_reduce_fused_pallas — sums (N, L) float32 lanes by segment
//     id into (S, L); ids outside [0, S) are dropped;
//   * segment_reduce_pallas — one-lane segment sum / min / max, empty
//     segments holding 0 / +inf / -inf.
// The TPU kernels build a one-hot matrix per (segment block, row block)
// and reduce it on the MXU: O(N * S) work that suits a machine without
// fast scattered writes.  Here the work is O(N), by one of two paths,
// chosen by byte count in lanes_per_tile() and nowhere else:
//
// smem — privatization, when one lane of the output (S * 4 bytes) fits in
//   the dynamic shared memory of a block (227 KB on an H100).  Each CTA
//   keeps an (S, chunk) tile of partials in shared memory, walks its rows
//   with coalesced reads, adds into the tile with shared-memory atomics,
//   then flushes the tile into the output with one global atomic an
//   entry.  The grid is one wave of resident CTAs: two of 512 threads a
//   SM at the hash groupby's 96 KB tile, one of 1024 where only one tile
//   fits.  Lanes that do not fit in one tile are split into chunks, one
//   tile a CTA, along the grid's y axis.
// direct — when S is too large (the sort groupby, where S is the capacity
//   and the ids arrive sorted): warp run-aggregation.  A warp reads 32
//   consecutive rows, finds the runs of equal ids with a ballot, reduces
//   each run with a segmented shuffle ladder and issues one global atomic
//   a run.  On unsorted ids every run is one row and the ladder is
//   skipped.  A warp loads four such chunks before it reduces them.
//
// Bound: memory.  Each value and id is read once (4 bytes each) and each
// output written once.  The old kernel's one global atomic per (row,
// lane) set its pace at the hash groupby, where 2^25 x 3 atomics land on
// about 3,072 hot addresses; shared-memory atomics take that contention
// off L2, and the flush adds only (CTAs x occupied entries) atomics.
//
// Sums.  The flush skips entries that are still 0.0.  That is exact: the
// output starts at +0.0, and x + (+-0.0) == x for every x except x = -0.0,
// which a sum that starts at +0.0 never reaches (in round-to-nearest a
// sum is -0.0 only if both operands are).  Float sums come out in another
// order than the reference's, so they agree to a tolerance; count lanes
// add 1.0s and stay exact below 2^24 per group.
//
// min/max reduce an order-preserving int32 key with native integer
// atomicMin/atomicMax: key(v) = bits ^ ((bits >> 31) & 0x7fffffff), which
// orders -0.0 below +0.0 as jax.ops.segment_min/max and jnp.minimum do.
// A NaN maps to INT_MIN for min and INT_MAX for max, so it wins, and it
// comes out as the canonical quiet NaN.  The output buffer holds the keys
// while the reduction runs: one pass turns the caller's initial values
// (the identity) into keys, one turns the keys back into floats.  A row,
// and a flushed partial, only reaches for its atomic when it would lower
// (raise) the value it reads first; values only move one way, so a stale
// read costs an atomic, never a wrong skip.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // rows a thread reads before it reduces them
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCanonicalNaN = 0x7fc00000;

enum { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ int order_key(float v) {
    const int b = __float_as_int(v);
    return b ^ ((b >> 31) & 0x7fffffff);
}

template <int OP> struct Reduce;

template <> struct Reduce<kSum> {
    using T = float;
    static __device__ __forceinline__ T identity() { return 0.0f; }
    static __device__ __forceinline__ T key(float v) { return v; }
    static __device__ __forceinline__ T combine(T a, T b) { return a + b; }
    // a sum always adds; an entry still 0.0 is not flushed (see above)
    static __device__ __forceinline__ bool moves(T, T) { return true; }
    static __device__ __forceinline__ bool empty(T p) { return p == 0.0f; }
    static __device__ __forceinline__ void atomic(T* a, T v) { atomicAdd(a, v); }
    static __device__ __forceinline__ void publish(T* a, T v) { atomicAdd(a, v); }
};

template <> struct Reduce<kMin> {
    using T = int;
    static __device__ __forceinline__ T identity() { return INT_MAX; }
    static __device__ __forceinline__ T key(float v) {
        return isnan(v) ? INT_MIN : order_key(v);
    }
    static __device__ __forceinline__ T combine(T a, T b) { return min(a, b); }
    static __device__ __forceinline__ bool moves(T cur, T v) { return v < cur; }
    static __device__ __forceinline__ bool empty(T p) { return p == INT_MAX; }
    static __device__ __forceinline__ void atomic(T* a, T v) { atomicMin(a, v); }
    // a global atomic only when it would lower the value read from L2
    static __device__ __forceinline__ void publish(T* a, T v) {
        if (v < __ldcg(a)) atomicMin(a, v);
    }
};

template <> struct Reduce<kMax> {
    using T = int;
    static __device__ __forceinline__ T identity() { return INT_MIN; }
    static __device__ __forceinline__ T key(float v) {
        return isnan(v) ? INT_MAX : order_key(v);
    }
    static __device__ __forceinline__ T combine(T a, T b) { return max(a, b); }
    static __device__ __forceinline__ bool moves(T cur, T v) { return v > cur; }
    static __device__ __forceinline__ bool empty(T p) { return p == INT_MIN; }
    static __device__ __forceinline__ void atomic(T* a, T v) { atomicMax(a, v); }
    static __device__ __forceinline__ void publish(T* a, T v) {
        if (v > __ldcg(a)) atomicMax(a, v);
    }
};

// Lane count as a compile-time constant where the groupby's shapes need
// speed (LANES = 1..4: every load of a row's lanes in flight at once),
// else the runtime ``width`` (LANES = 0).
template <int LANES>
__device__ __forceinline__ int lanes_of(int width) {
    return LANES > 0 ? LANES : width;
}

// smem path.  Block (x, y) reduces rows x, x + gridDim.x * blockDim.x, ...
// over lanes [y * width, y * width + width) of the row stride ``lanes``
// into an (S, width) tile; out is (S, lanes), as keys for min/max.
template <int OP, int LANES>
__global__ void __launch_bounds__(2 * kThreads, 1)
segment_smem_kernel(const float* __restrict__ values,
                    const int32_t* __restrict__ seg, int64_t n, int lanes,
                    int width, int num_segments,
                    typename Reduce<OP>::T* __restrict__ out) {
    using R = Reduce<OP>;
    using T = typename R::T;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tile = reinterpret_cast<T*>(smem_raw);
    const int w = lanes_of<LANES>(width);
    const int lane0 = blockIdx.y * w;
    const int cw = min(w, lanes - lane0);  // the last chunk may be narrower
    const int entries = num_segments * w;
    for (int j = threadIdx.x; j < entries; j += blockDim.x) tile[j] = R::identity();
    __syncthreads();

    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         base < n; base += stride * kUnroll) {
        int32_t s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int64_t row = base + u * stride;
            s[u] = row < n ? __ldg(seg + row) : -1;
        }
        if (LANES > 0) {
            float v[kUnroll][LANES > 0 ? LANES : 1];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int64_t row = base + u * stride;
#pragma unroll
                for (int c = 0; c < (LANES > 0 ? LANES : 1); ++c) {
                    v[u][c] = (row < n && c < cw)
                                  ? __ldg(values + row * lanes + lane0 + c)
                                  : 0.0f;
                }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (s[u] < 0 || s[u] >= num_segments) continue;
#pragma unroll
                for (int c = 0; c < (LANES > 0 ? LANES : 1); ++c) {
                    if (c >= cw) break;
                    T* a = tile + s[u] * w + c;
                    const T k = R::key(v[u][c]);
                    if (R::moves(*a, k)) R::atomic(a, k);
                }
            }
        } else {
            for (int c = 0; c < cw; ++c) {
                float v[kUnroll];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const int64_t row = base + u * stride;
                    v[u] = row < n ? __ldg(values + row * lanes + lane0 + c) : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    if (s[u] < 0 || s[u] >= num_segments) continue;
                    T* a = tile + s[u] * w + c;
                    const T k = R::key(v[u]);
                    if (R::moves(*a, k)) R::atomic(a, k);
                }
            }
        }
    }
    __syncthreads();

    // flush: one global atomic an entry that holds a partial
    for (int j = threadIdx.x; j < entries; j += blockDim.x) {
        const int c = j % w;
        if (c >= cw) continue;
        const T p = tile[j];
        if (R::empty(p)) continue;
        R::publish(out + static_cast<int64_t>(j / w) * lanes + lane0 + c, p);
    }
}

// Reduce x over the run of equal ids that ends at this lane: ``heads`` has
// a bit for every lane that starts a run (lane 0 always does).
template <class R>
__device__ __forceinline__ typename R::T run_reduce(typename R::T x,
                                                    unsigned heads, int lane) {
    if (heads == kFull) return x;  // every row is its own run
    const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const typename R::T y = __shfl_up_sync(kFull, x, d);
        if (lane - d >= start) x = R::combine(y, x);
    }
    return x;
}

// direct path: warp run-aggregation, one global atomic a run.  Each warp
// walks kChunks chunks of 32 consecutive rows at a time, all their loads
// first (the loop bound is warp-uniform, so every shuffle has the whole
// warp).
template <int OP, int LANES>
__global__ void __launch_bounds__(kThreads, 2)
segment_direct_kernel(const float* __restrict__ values,
                      const int32_t* __restrict__ seg, int64_t n, int lanes,
                      int64_t num_segments,
                      typename Reduce<OP>::T* __restrict__ out) {
    using R = Reduce<OP>;
    using T = typename R::T;
    constexpr int kChunks = 4;
    constexpr int kMaxLanes = LANES > 0 ? LANES : 1;
    const int lane = threadIdx.x & 31;
    const int64_t warp =
        (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
    const int nl = lanes_of<LANES>(lanes);
    for (int64_t base = warp * 32 * kChunks; base < n;
         base += warps * 32 * kChunks) {
        int32_t s[kChunks];
        float v[kChunks][kMaxLanes];
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
            const int64_t row = base + u * 32 + lane;
            s[u] = row < n ? __ldg(seg + row) : -1;
            if (LANES > 0) {
#pragma unroll
                for (int c = 0; c < kMaxLanes; ++c)
                    v[u][c] = row < n ? __ldg(values + row * lanes + c) : 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
            const int64_t row = base + u * 32 + lane;
            const bool valid = s[u] >= 0 && s[u] < num_segments;
            const int32_t prev = __shfl_up_sync(kFull, s[u], 1);
            const unsigned heads =
                __ballot_sync(kFull, lane == 0 || s[u] != prev);
            const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
            for (int c = 0; c < nl; ++c) {
                const float x =
                    LANES > 0 ? v[u][c < kMaxLanes ? c : 0]
                              : (row < n ? __ldg(values + row * lanes + c) : 0.0f);
                const T r = run_reduce<R>(valid ? R::key(x) : R::identity(),
                                          heads, lane);
                if (tail && valid)
                    R::publish(out + static_cast<int64_t>(s[u]) * lanes + c, r);
            }
        }
    }
}

// out[i]: the caller's float → its key (min/max), in place.
template <int OP>
__global__ void keys_from_floats(int* out, int64_t n) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        out[i] = Reduce<OP>::key(__int_as_float(out[i]));
    }
}

// out[i]: key → float, in place; the NaN key becomes the canonical NaN.
template <int OP>
__global__ void floats_from_keys(int* out, int64_t n) {
    constexpr int nan_key = OP == kMin ? INT_MIN : INT_MAX;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const int k = out[i];
        out[i] = k == nan_key ? kCanonicalNaN : k ^ ((k >> 31) & 0x7fffffff);
    }
}

struct DeviceInfo {
    int sms = 0;
    int smem_optin = 0;  // dynamic shared memory a block may opt in to
};

const DeviceInfo& device_info() {
    static DeviceInfo info[64];
    int dev = 0;
    cudaGetDevice(&dev);
    DeviceInfo& d = info[dev & 63];
    if (d.sms == 0) {
        cudaDeviceGetAttribute(&d.smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return d;
}

// The one place that picks the path: how many lanes of an (S, lanes)
// output one block's shared memory holds (0: the direct path).
int64_t lanes_per_tile(int64_t num_segments, int lanes) {
    if (num_segments <= 0 || lanes <= 0) return 0;
    const int64_t fit = device_info().smem_optin / (num_segments * 4);
    return fit < lanes ? fit : lanes;
}

template <int OP, int LANES>
cudaError_t launch_smem(const float* values, const int32_t* seg, int64_t n,
                        int lanes, int width, int chunks, int64_t num_segments,
                        typename Reduce<OP>::T* out, cudaStream_t stream) {
    auto kernel = segment_smem_kernel<OP, LANES>;
    const DeviceInfo& d = device_info();
    static bool opted_in[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (!opted_in[dev & 63]) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_optin);
        if (err != cudaSuccess) return err;
        opted_in[dev & 63] = true;
    }
    const size_t bytes = static_cast<size_t>(num_segments) * width * 4;
    // CTAs of 512 threads where two fit on an SM, else one of 1024, so that
    // an SM keeps 1024 threads' loads in flight either way
    int threads = kThreads, per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, bytes);
    if (err == cudaSuccess && per_sm < 2) {
        threads = 2 * kThreads;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, bytes);
    }
    if (err != cudaSuccess) return err;
    // one wave of resident CTAs, split over the lane chunks; no more CTAs
    // than the rows keep busy, since each one zeroes and flushes its tile
    int64_t blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * d.sms / chunks;
    const int64_t work = num_segments * width > threads * kUnroll
                             ? num_segments * width
                             : threads * kUnroll;
    const int64_t need = (n + work - 1) / work;
    if (blocks > need) blocks = need;
    if (blocks < 1) blocks = 1;
    kernel<<<dim3(static_cast<unsigned>(blocks), chunks), threads, bytes, stream>>>(
        values, seg, n, lanes, width, static_cast<int>(num_segments), out);
    return cudaGetLastError();
}

template <int OP, int LANES>
cudaError_t launch_direct(const float* values, const int32_t* seg, int64_t n,
                          int lanes, int64_t num_segments,
                          typename Reduce<OP>::T* out, cudaStream_t stream) {
    segment_direct_kernel<OP, LANES>
        <<<hptmt::grid_for(n, kThreads), kThreads, 0, stream>>>(
            values, seg, n, lanes, num_segments, out);
    return cudaGetLastError();
}

// Sums of (n, lanes) values into out (S, lanes), which the caller zeroed.
cudaError_t reduce_sum(const float* values, const int32_t* seg, int64_t n,
                       int lanes, int64_t num_segments, float* out,
                       cudaStream_t stream) {
    const int64_t per_tile = lanes_per_tile(num_segments, lanes);
    if (per_tile > 0) {
        const int chunks = static_cast<int>((lanes + per_tile - 1) / per_tile);
        const int width = (lanes + chunks - 1) / chunks;
        switch (width) {
            case 1: return launch_smem<kSum, 1>(values, seg, n, lanes, 1, chunks, num_segments, out, stream);
            case 2: return launch_smem<kSum, 2>(values, seg, n, lanes, 2, chunks, num_segments, out, stream);
            case 3: return launch_smem<kSum, 3>(values, seg, n, lanes, 3, chunks, num_segments, out, stream);
            case 4: return launch_smem<kSum, 4>(values, seg, n, lanes, 4, chunks, num_segments, out, stream);
            default: return launch_smem<kSum, 0>(values, seg, n, lanes, width, chunks, num_segments, out, stream);
        }
    }
    switch (lanes) {
        case 1: return launch_direct<kSum, 1>(values, seg, n, lanes, num_segments, out, stream);
        case 2: return launch_direct<kSum, 2>(values, seg, n, lanes, num_segments, out, stream);
        case 3: return launch_direct<kSum, 3>(values, seg, n, lanes, num_segments, out, stream);
        case 4: return launch_direct<kSum, 4>(values, seg, n, lanes, num_segments, out, stream);
        default: return launch_direct<kSum, 0>(values, seg, n, lanes, num_segments, out, stream);
    }
}

// One-lane min/max into out (S,), which the caller filled with floats (the
// identity): to keys, reduce, back to floats.
template <int OP>
cudaError_t reduce_minmax(const float* values, const int32_t* seg, int64_t n,
                          int64_t num_segments, float* out_f, cudaStream_t stream) {
    int* out = reinterpret_cast<int*>(out_f);
    const unsigned blocks = hptmt::grid_for(num_segments, 256);
    keys_from_floats<OP><<<blocks, 256, 0, stream>>>(out, num_segments);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = lanes_per_tile(num_segments, 1) > 0
              ? launch_smem<OP, 1>(values, seg, n, 1, 1, 1, num_segments, out, stream)
              : launch_direct<OP, 1>(values, seg, n, 1, num_segments, out, stream);
    if (err != cudaSuccess) return err;
    floats_from_keys<OP><<<blocks, 256, 0, stream>>>(out, num_segments);
    return cudaGetLastError();
}

}  // namespace

// 1 when an (num_segments, lanes) reduction takes the smem path on the
// current device, 0 for the direct path (the wrappers count launches by
// path with it).
HPTMT_API int hptmt_segment_privatized(int64_t num_segments, int lanes) {
    return lanes_per_tile(num_segments, lanes) > 0 ? 1 : 0;
}

// values (n, lanes) float32, seg (n,) int32 → out (num_segments, lanes)
// float32, zeroed by the caller.
HPTMT_API int hptmt_segment_sum_fused(const void* values, const void* seg,
                                      int64_t n, int lanes,
                                      int64_t num_segments, void* out,
                                      void* stream) {
    if (n <= 0 || lanes <= 0 || num_segments <= 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(reduce_sum(
        static_cast<const float*>(values), static_cast<const int32_t*>(seg), n,
        lanes, num_segments, static_cast<float*>(out),
        static_cast<cudaStream_t>(stream)));
}

// values (n,) float32, seg (n,) int32 → out (num_segments,) float32, which
// the caller fills with the identity (0, +inf or -inf).  The one-lane sum
// is the fused sum with one lane.
HPTMT_API int hptmt_segment_reduce(const void* values, const void* seg,
                                   int64_t n, int64_t num_segments, int op,
                                   void* out, void* stream) {
    if (op < 0 || op > 2) return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0 || num_segments <= 0) return static_cast<int>(cudaGetLastError());
    const float* v = static_cast<const float*>(values);
    const int32_t* g = static_cast<const int32_t*>(seg);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (op == kSum) {
        err = reduce_sum(v, g, n, 1, num_segments, o, s);
    } else if (op == kMin) {
        err = reduce_minmax<kMin>(v, g, n, num_segments, o, s);
    } else {
        err = reduce_minmax<kMax>(v, g, n, num_segments, o, s);
    }
    return static_cast<int>(err);
}
