// Segment reductions of the groupby for Hopper.
//
// Replaces two TPU kernels of src/repro/kernels/segment_reduce/kernel.py:
//   * segment_reduce_fused_pallas — sums (N, L) float32 lanes by segment
//     id into (S, L); ids outside [0, S) are dropped;
//   * segment_reduce_pallas — one-lane segment sum / min / max, empty
//     segments holding 0 / +inf / -inf.
// The TPU kernels build a one-hot matrix per (segment block, row block)
// and reduce it on the MXU: O(N * S) work that suits a machine without
// fast scattered writes.  Hopper has fast atomics in L2, so the port does
// O(N) work instead: one thread per (row, lane) adds into the output with
// an atomic.
//
// Bound: memory.  Each value and id is read once (4 bytes each) and each
// output written once; the atomics resolve in L2.  At a few thousand
// groups (the hash groupby) the atomics contend on few addresses and set
// the pace; at one group per few rows (the sort groupby) they do not.
// Float sums come out in another order than the reference's, so they
// agree to a tolerance (count lanes add 1.0s and stay exact below 2^24 per
// group).
//
// min/max propagate NaN exactly as the reference (jax.ops.segment_min/max)
// does: a segment holding a NaN yields NaN.  They use a compare-and-swap
// loop on the float bits: an ordered-int atomicMin would order NaN bit
// patterns as numbers and lose them.
#include "common.cuh"

namespace {

__global__ void segment_sum_fused_kernel(const float* __restrict__ values,
                                         const int32_t* __restrict__ seg,
                                         int64_t n, int lanes,
                                         int64_t num_segments,
                                         float* __restrict__ out) {
    const int64_t total = n * lanes;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int64_t row = i / lanes;
        const int lane = static_cast<int>(i - row * lanes);
        const int32_t s = seg[row];
        if (s >= 0 && s < num_segments) {
            atomicAdd(out + static_cast<int64_t>(s) * lanes + lane, values[i]);
        }
    }
}

// out[s] = op(out[s], v) with NaN winning: once a NaN is stored it stays,
// and a NaN value replaces any number.
template <bool IS_MIN>
__device__ __forceinline__ void atomic_minmax(float* addr, float v) {
    int* iaddr = reinterpret_cast<int*>(addr);
    int old_bits = *reinterpret_cast<volatile int*>(iaddr);
    while (true) {
        const float old = __int_as_float(old_bits);
        if (isnan(old)) return;
        const bool replace = isnan(v) || (IS_MIN ? (v < old) : (v > old));
        if (!replace) return;
        const int prev = atomicCAS(iaddr, old_bits, __float_as_int(v));
        if (prev == old_bits) return;
        old_bits = prev;
    }
}

template <int OP>  // 0 sum, 1 min, 2 max
__global__ void segment_reduce_kernel(const float* __restrict__ values,
                                      const int32_t* __restrict__ seg,
                                      int64_t n, int64_t num_segments,
                                      float* __restrict__ out) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const int32_t s = seg[i];
        if (s < 0 || s >= num_segments) continue;
        const float v = values[i];
        if (OP == 0) {
            atomicAdd(out + s, v);
        } else {
            atomic_minmax<OP == 1>(out + s, v);
        }
    }
}

}  // namespace

// values (n, lanes) float32, seg (n,) int32 → out (num_segments, lanes)
// float32, zeroed by the caller.
HPTMT_API int hptmt_segment_sum_fused(const void* values, const void* seg,
                                      int64_t n, int lanes,
                                      int64_t num_segments, void* out,
                                      void* stream) {
    constexpr int threads = 256;
    const int64_t total = n * lanes;
    if (total > 0) {
        segment_sum_fused_kernel<<<hptmt::grid_for(total, threads), threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(values), static_cast<const int32_t*>(seg),
            n, lanes, num_segments, static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}

// values (n,) float32, seg (n,) int32 → out (num_segments,) float32, which
// the caller fills with the identity (0, +inf or -inf).
HPTMT_API int hptmt_segment_reduce(const void* values, const void* seg,
                                   int64_t n, int64_t num_segments, int op,
                                   void* out, void* stream) {
    constexpr int threads = 256;
    if (n > 0) {
        const unsigned blocks = hptmt::grid_for(n, threads);
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        const float* v = static_cast<const float*>(values);
        const int32_t* g = static_cast<const int32_t*>(seg);
        float* o = static_cast<float*>(out);
        if (op == 0) {
            segment_reduce_kernel<0><<<blocks, threads, 0, s>>>(v, g, n, num_segments, o);
        } else if (op == 1) {
            segment_reduce_kernel<1><<<blocks, threads, 0, s>>>(v, g, n, num_segments, o);
        } else if (op == 2) {
            segment_reduce_kernel<2><<<blocks, threads, 0, s>>>(v, g, n, num_segments, o);
        } else {
            return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
