// Hash-join probe for Hopper (the counted two-pass scheme's one walk).
//
// Replaces the TPU kernel probe_pallas
// (src/repro/kernels/hash_join/kernel.py).  For each probe row it walks
// the double-hash sequence slot_j = (h1 + j * (h2 | 1)) & (S - 1) over the
// open-addressing table for at most max_probes steps and stops at the
// first empty slot.  A candidate matches when its h2 and every key lane
// are bitwise equal.  Outputs: the match count, the first max_matches
// build rows in chain order (rimat, -1 padded) and `exhausted` (the walk
// hit max_probes while still on an occupied chain).
//
// Bound: memory latency and sectors.  Each visited slot costs three
// dependent random reads (table_row, then slot_h2 and the key lanes) —
// three 32-byte sectors for 4-12 useful bytes — and the table (12 bytes a
// slot at one key lane, 400 MB at S = 2^25) is far larger than L2.  The
// TPU kernel kept the table VMEM-resident and capped its size; here the
// table stays in device memory at any size, and the design hides latency
// with occupancy instead: one thread per probe row, no shared memory, few
// registers, so many warps are in flight while their gathers wait.  Each
// thread exits on its own at its first empty slot, so a short chain never
// waits for a long one (the TPU kernel looped until the whole block was
// done).  The result is bit-identical to repro_torch ref.probe.
#include "common.cuh"

namespace {

__global__ void probe_kernel(const int32_t* __restrict__ table_row,
                             const uint32_t* __restrict__ slot_h2,
                             const uint32_t* __restrict__ slot_keys,
                             uint32_t slot_mask, int lanes,
                             const uint32_t* __restrict__ ph1,
                             const uint32_t* __restrict__ ph2,
                             const uint32_t* __restrict__ pkeys,
                             const uint8_t* __restrict__ pvalid, int64_t n,
                             int max_matches, int max_probes,
                             int32_t* __restrict__ cnt_out,
                             int32_t* __restrict__ rimat,
                             uint8_t* __restrict__ exhausted) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         row < n; row += stride) {
        int32_t* regs = rimat + row * max_matches;
        for (int m = 0; m < max_matches; ++m) regs[m] = -1;
        bool active = pvalid[row] != 0;
        int32_t cnt = 0;
        if (active) {
            const uint32_t h1 = ph1[row];
            const uint32_t h2 = ph2[row];
            const uint32_t step = h2 | 1u;
            const uint32_t* pk = pkeys + row * lanes;
            for (int j = 0; j < max_probes; ++j) {
                const uint32_t slot = (h1 + static_cast<uint32_t>(j) * step) & slot_mask;
                const int32_t brow = table_row[slot];
                if (brow < 0) {  // first empty slot: no further equal keys
                    active = false;
                    break;
                }
                if (slot_h2[slot] == h2) {
                    const uint32_t* sk = slot_keys + static_cast<int64_t>(slot) * lanes;
                    bool eq = true;
                    for (int l = 0; l < lanes; ++l) eq &= (sk[l] == pk[l]);
                    if (eq) {
                        if (cnt < max_matches) regs[cnt] = brow;
                        ++cnt;
                    }
                }
            }
        }
        cnt_out[row] = cnt;
        exhausted[row] = active ? 1 : 0;
    }
}

}  // namespace

// table_row (S,) int32 (-1 = empty), slot_h2 (S,) uint32, slot_keys
// (S, lanes) uint32 with S a power of two; ph1/ph2 (n,) uint32, pkeys
// (n, lanes) uint32, pvalid (n,) bool → cnt (n,) int32, rimat
// (n, max_matches) int32, exhausted (n,) bool.
HPTMT_API int hptmt_probe(const void* table_row, const void* slot_h2,
                          const void* slot_keys, int64_t slots, int lanes,
                          const void* ph1, const void* ph2, const void* pkeys,
                          const void* pvalid, int64_t n, int max_matches,
                          int max_probes, void* cnt, void* rimat,
                          void* exhausted, void* stream) {
    constexpr int threads = 256;
    if (n > 0) {
        probe_kernel<<<hptmt::grid_for(n, threads, 132 * 64), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(table_row),
            static_cast<const uint32_t*>(slot_h2),
            static_cast<const uint32_t*>(slot_keys),
            static_cast<uint32_t>(slots - 1), lanes,
            static_cast<const uint32_t*>(ph1), static_cast<const uint32_t*>(ph2),
            static_cast<const uint32_t*>(pkeys),
            static_cast<const uint8_t*>(pvalid), n, max_matches, max_probes,
            static_cast<int32_t*>(cnt), static_cast<int32_t*>(rimat),
            static_cast<uint8_t*>(exhausted));
    }
    return static_cast<int>(cudaGetLastError());
}
