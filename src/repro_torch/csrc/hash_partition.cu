// Hash partition of the shuffle (paper Fig 2 hot loop) for Hopper.
//
// Replaces the TPU kernel hash_partition_pallas
// (src/repro/kernels/hash_partition/kernel.py): in one pass over the key
// lanes it computes the two-lane murmur chain (h1, h2), the destination
// h1 % P (invalid rows go to P) and the per-destination histogram.
//
// Bound: memory.  Per row it reads K key lanes (4 bytes each) and one
// valid byte and writes a 4-byte destination (plus 8 bytes of hashes when
// asked), against ~12 integer operations per lane — far below the card's
// operation rate.  Design: one thread per row with coalesced row-major
// loads; the histogram is counted per block in shared memory, first
// aggregated per warp with __match_any_sync (a warp's rows mostly share
// few destinations when P is small), then flushed once per block with
// integer atomicAdd — exact and independent of order.
//
// The chain must match repro_torch.core.table.hash_columns bit for bit.
#include "common.cuh"

namespace {

constexpr uint32_t H1_INIT = 0x9E3779B9u;
constexpr uint32_t H2_INIT = 0x85EBCA6Bu;
constexpr uint32_t MUL1 = 0xCC9E2D51u;
constexpr uint32_t MUL2 = 0x1B873593u;
constexpr uint32_t K2_XOR = 0xDEADBEEFu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t k, uint32_t mul) {
    k *= mul;
    k = rotl(k, 15);
    h ^= k;
    h = rotl(h, 13);
    return h * 5u + 0xE6546B64u;
}

__global__ void hash_partition_kernel(const uint32_t* __restrict__ keys,
                                      int64_t n, int k,
                                      const uint8_t* __restrict__ valid,
                                      int n_parts, int32_t* __restrict__ dest,
                                      int32_t* __restrict__ hist,
                                      uint32_t* __restrict__ h1_out,
                                      uint32_t* __restrict__ h2_out) {
    extern __shared__ int32_t local_hist[];
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x) local_hist[p] = 0;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    // the loop bound is uniform across the block, so every warp stays
    // converged for __match_any_sync
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
         base < n; base += stride) {
        const int64_t row = base + threadIdx.x;
        int d = n_parts;
        if (row < n) {
            uint32_t h1 = H1_INIT, h2 = H2_INIT;
            const uint32_t* kr = keys + row * k;
            for (int c = 0; c < k; ++c) {
                const uint32_t key = kr[c];
                h1 = mix(h1, key, MUL1);
                h2 = mix(h2, key ^ K2_XOR, MUL2);
            }
            h1 ^= h1 >> 16;
            h2 ^= h2 >> 16;
            if (valid[row]) d = static_cast<int>(h1 % static_cast<uint32_t>(n_parts));
            dest[row] = d;
            if (h1_out != nullptr) {
                h1_out[row] = h1;
                h2_out[row] = h2;
            }
        }
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (d < n_parts && lane == __ffs(peers) - 1) {
            atomicAdd(&local_hist[d], __popc(peers));
        }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
        const int32_t c = local_hist[p];
        if (c != 0) atomicAdd(&hist[p], c);
    }
}

}  // namespace

// keys (n, k) uint32 row-major, valid (n,) bool → dest (n,) int32 with
// invalid rows = n_parts, hist (n_parts,) int32 (zeroed by the caller),
// and h1/h2 (n,) uint32 when both pointers are non-null.
HPTMT_API int hptmt_hash_partition(const void* keys, int64_t n, int k,
                                   const void* valid, int n_parts, void* dest,
                                   void* hist, void* h1, void* h2,
                                   void* stream) {
    constexpr int threads = 256;
    const unsigned blocks = hptmt::grid_for(n, threads);
    const size_t smem = static_cast<size_t>(n_parts) * sizeof(int32_t);
    if (n > 0) {
        hash_partition_kernel<<<blocks, threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(keys), n, k,
            static_cast<const uint8_t*>(valid), n_parts,
            static_cast<int32_t*>(dest), static_cast<int32_t*>(hist),
            static_cast<uint32_t*>(h1), static_cast<uint32_t*>(h2));
    }
    return static_cast<int>(cudaGetLastError());
}
