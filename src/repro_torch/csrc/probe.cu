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
// Bound: random slot reads.  The table (2^25 slots at the main path's
// join, 512 MB) is far larger than L2, so each visit is one random read
// from device memory, and the walk's order is fixed by the reference.
// What the design chooses is what a visit costs:
//
//   * One aligned record a slot (hash_join/ref.py slot_records).  For keys
//     of up to two 32-bit lanes the record is 16 bytes, {row, h2, k0, k1}
//     (row = -1: empty), so a visit is one ld.global.nc.v4: one 32-byte
//     sector and one latency, where three separate arrays cost up to three
//     dependent sectors (row, then h2, then the keys).  For three or more
//     lanes the record is 8 bytes, {row, h2}, and the key lanes sit in a
//     slot-major side array read only when h2 matches.  Two key lanes of a
//     probe row are read as one 8-byte vector.
//   * One thread a probe row, no shared memory and few registers, so many
//     warps are in flight while their reads wait; each thread stops at its
//     own first empty slot, so a short chain never waits for a long one.
//   * No read-ahead.  The next record's address is known before the current
//     one arrives (slot + step), but the walk is bound by the card's rate
//     of random sector reads, not by their latency: a variant that loads
//     the next record with the current one reads past each row's first
//     empty slot, about 40% more sectors, and ran 1.38x slower on an H100
//     80GB HBM3 (700 W) at the main path's join
//     (scripts/kernels_before_after.py builds it from a patched copy).
//
// The TPU kernel kept the table VMEM-resident and capped its size; here
// the table stays in device memory at any size.  The result is
// bit-identical to repro_torch ref.probe.
#include "common.cuh"

namespace {

// One slot record as one vector load through the non-coherent path
// (ld.global.nc.v4 / .v2): the table is read-only for the kernel's
// lifetime.
__device__ __forceinline__ int4 load_record(const int4* rec, uint32_t slot) {
    return __ldg(rec + slot);
}

__device__ __forceinline__ int4 load_record(const int2* rec, uint32_t slot) {
    const int2 r = __ldg(rec + slot);
    return make_int4(r.x, r.y, 0, 0);
}

// Rec = int4 (lanes <= 2, keys in the record) or int2 (keys in `side`).
template <typename Rec>
__global__ void probe_kernel(const Rec* __restrict__ rec,
                             const uint32_t* __restrict__ side,
                             uint32_t slot_mask, int lanes,
                             const uint32_t* __restrict__ ph1,
                             const uint32_t* __restrict__ ph2,
                             const uint32_t* __restrict__ pkeys,
                             const uint8_t* __restrict__ pvalid, int64_t n,
                             int max_matches, int max_probes,
                             int32_t* __restrict__ cnt_out,
                             int32_t* __restrict__ rimat,
                             uint8_t* __restrict__ exhausted) {
    constexpr bool kInline = sizeof(Rec) == 16;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         row < n; row += stride) {
        int32_t* regs = rimat + row * max_matches;
        bool active = pvalid[row] != 0;
        int32_t cnt = 0;
        if (active) {
            const uint32_t h2 = ph2[row];
            const uint32_t step = h2 | 1u;
            const uint32_t* pk = pkeys + row * lanes;
            uint32_t k0 = 0, k1 = 0;
            if (kInline) {
                if (lanes == 2) {
                    const uint2 k = *reinterpret_cast<const uint2*>(pk);
                    k0 = k.x;
                    k1 = k.y;
                } else {
                    k0 = pk[0];
                }
            }
            uint32_t slot = ph1[row] & slot_mask;
            for (int j = 0; j < max_probes; ++j) {
                const int4 cur = load_record(rec, slot);
                if (cur.x < 0) {  // first empty slot: no further equal keys
                    active = false;
                    break;
                }
                if (static_cast<uint32_t>(cur.y) == h2) {
                    bool eq;
                    if (kInline) {
                        eq = static_cast<uint32_t>(cur.z) == k0
                             && static_cast<uint32_t>(cur.w) == k1;
                    } else {
                        const uint32_t* sk = side + static_cast<int64_t>(slot) * lanes;
                        eq = true;
                        for (int l = 0; l < lanes; ++l) eq &= (sk[l] == pk[l]);
                    }
                    if (eq) {
                        if (cnt < max_matches) regs[cnt] = cur.x;
                        ++cnt;
                    }
                }
                slot = (slot + step) & slot_mask;
            }  // still active: max_probes reached on an occupied chain
        }
        for (int m = min(cnt, max_matches); m < max_matches; ++m) regs[m] = -1;
        cnt_out[row] = cnt;
        exhausted[row] = active ? 1 : 0;
    }
}

}  // namespace

// rec: (S, 4) int32 {row, h2, k0, k1} when lanes <= 2 (side unused), or
// (S, 2) int32 {row, h2} with side (S, lanes) uint32 when lanes >= 3; row
// -1 = empty; S a power of two.  ph1/ph2 (n,) uint32, pkeys (n, lanes)
// uint32 (8-byte aligned when lanes == 2), pvalid (n,) bool → cnt (n,)
// int32, rimat (n, max_matches) int32, exhausted (n,) bool.
HPTMT_API int hptmt_probe(const void* rec, const void* side, int64_t slots,
                          int lanes, const void* ph1, const void* ph2,
                          const void* pkeys, const void* pvalid, int64_t n,
                          int max_matches, int max_probes, void* cnt,
                          void* rimat, void* exhausted, void* stream) {
    if (lanes < 1 || max_matches < 1 || slots < 1 || (slots & (slots - 1))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n <= 0) return static_cast<int>(cudaSuccess);
    constexpr int threads = 256;
    const unsigned grid = hptmt::grid_for(n, threads, 132 * 64);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t mask = static_cast<uint32_t>(slots - 1);
    const auto* h1 = static_cast<const uint32_t*>(ph1);
    const auto* h2 = static_cast<const uint32_t*>(ph2);
    const auto* pk = static_cast<const uint32_t*>(pkeys);
    const auto* pv = static_cast<const uint8_t*>(pvalid);
    auto* c = static_cast<int32_t*>(cnt);
    auto* r = static_cast<int32_t*>(rimat);
    auto* e = static_cast<uint8_t*>(exhausted);
    if (lanes <= 2) {
        probe_kernel<int4><<<grid, threads, 0, s>>>(
            static_cast<const int4*>(rec), nullptr, mask, lanes, h1, h2, pk,
            pv, n, max_matches, max_probes, c, r, e);
    } else {
        probe_kernel<int2><<<grid, threads, 0, s>>>(
            static_cast<const int2*>(rec), static_cast<const uint32_t*>(side),
            mask, lanes, h1, h2, pk, pv, n, max_matches, max_probes, c, r, e);
    }
    return static_cast<int>(cudaGetLastError());
}
