// Masked online-softmax attention forward (flash attention) for bfloat16
// on Hopper's tensor cores: wgmma for both products, TMA for the tiles.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, pallas_call at :134) for
// bfloat16 inputs; float32 inputs run the SIMT kernel of
// flash_attention.cu (TF32 would not hold float32's 2e-4).  The TPU kernel
// walks a sequential grid over key blocks and carries the running max,
// sum and accumulator in VMEM scratch; here one CTA owns 128 query rows of
// one (batch, head) and loops over the 64-key blocks itself.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// phi3-mini prefill (q/k/v (8, 32, 1024, 96) bf16, causal) the masks
// allow 51.6 GFLOP of products, 0.052 ms at the tensor-core rate, against
// 201 MB of q, k, v and o, 0.060 ms at the memory rate: the two bounds are
// within 15% of each other, so the kernel has to keep the tensor cores
// busy and read every byte once.  The design:
//
//   * CTA = 2 consumer warpgroups + 1 producer warpgroup (384 threads),
//     the producer giving its registers to the consumers (setmaxnreg 40 /
//     232).  Each consumer warpgroup owns 64 query rows; both share every
//     K/V tile.
//   * One producer thread brings Q once and the K/V tiles through a ring
//     of kStages stages with TMA (cp.async.bulk.tensor), each stage
//     signalled by a "full" mbarrier (transaction bytes) and released by
//     an "empty" mbarrier (one arrival per consumer warp), so the loads of
//     the next tiles overlap the products on this one.
//   * S = Q K^T runs as wgmma m64n64k16 with both operands in shared
//     memory (K-major); O += P V as wgmma m64nNk16 with P in registers (the
//     S accumulator's fragment layout is the A operand's layout, so P never
//     touches shared memory) and V from shared memory with the transpose
//     bit (V tiles are key-major, i.e. MN-major for this product).
//   * Tiles live in the canonical 128-byte-swizzled layout that TMA writes
//     with CU_TENSOR_MAP_SWIZZLE_128B: one TMA box is 64 bf16 (128 bytes)
//     wide, so a head dim above 64 takes two boxes (chunks) per tile and
//     the columns past D are zero-filled by TMA.  Three instances: N = 64,
//     96, 128 (D rounded up); QK^T runs N / 16 k-steps and PV is m64nNk16,
//     so phi3's D = 96 and smollm's 64 compute no zero column (another D
//     computes its padding to N as zeros).
//   * Masks and the online softmax run on the accumulator fragments: a
//     thread holds 2 rows (lane / 4 and lane / 4 + 8 of its warp's 16) and
//     2 adjacent columns of every 8; row max and row sum reduce over the
//     quad of lanes that share a row.  A key block fully masked for a
//     warpgroup (above the causal diagonal, outside the window) is skipped
//     by that warpgroup; the CTA's block range covers both; the query
//     blocks run heaviest (latest) first.
//
// Numerics: S accumulates in float32 on the tensor cores.  P enters P V as
// kParts = 3 bf16 terms (hi = bf16(P), then the rounded remainders), so P
// is carried to ~24 bits; each tile's P V is a fresh tensor-core sum, and
// O = alpha O + P V is summed across tiles in float32 on the FMA units,
// rounded to nearest; the row sum l sums the float32 P.  P rounded once
// to bf16 (as the TPU's MXU takes it for the Pallas kernel's
// default-precision dot) moved full-size phi3 and smollm prefill logits
// 0.021 and 0.022 of the largest logit from the plain path, over the 2e-2
// that chip_smoke.py holds; the three terms and the float32 sum across
// tiles cut the share of bf16 outputs that differ from the plain path's
// from 0.22% (two terms) to 0.04% (float32 on the FMA units: 0.02%), for
// 11% more kernel time than two terms (scripts/flash_variants.py).
// Scores are scaled by sm_scale * log2(e) and exponentiated with exp2
// (the same function as exp of the unscaled score).  Semantics of the
// Pallas kernel: initial running max -1e30, masked probabilities exactly
// 0, rows with l == 0 write 0; masks on absolute positions (query row i
// at q_offset + i; key j visible iff j < kv_len, (causal) j <= q_pos,
// (window) q_pos - j < window); GQA: query head h reads kv head
// h / (Hq / Hkv) without repeating K/V; output in bfloat16.
//
// Inputs are strided views with a contiguous head dim; TMA needs a
// 16-byte-aligned base and 16-byte-multiple strides (the wrapper copies a
// view that breaks them).  Each call encodes three tensor maps on the host
// (cuTensorMapEncodeTiled, fetched from libcuda with dlsym so nothing new
// is linked) and passes them as __grid_constant__ parameters.
#include "common.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>

namespace {

constexpr int kBQ = 128;       // query rows of one CTA (64 per warpgroup)
constexpr int kBK = 64;        // keys of one tile
constexpr int kStages = 3;     // K/V ring depth
constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kChunkCols = 64;             // bf16 columns of one TMA box
constexpr int kRowBytes = 128;             // = kChunkCols * 2, the swizzle span
constexpr int kQChunk = kBQ * kRowBytes;   // bytes of one 64-column Q chunk
constexpr int kKVChunk = kBK * kRowBytes;  // of one K or V chunk
constexpr int kParts = 3;                  // bf16 terms of P in P V
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Which coordinate of a tensor map holds the sequence, head and batch
// index (coordinate 0 is always the head dim).  The host orders the outer
// dimensions by stride.
struct Dims {
    int s, h, b;
};

struct Params {
    __nv_bfloat16* o;
    int64_t o_sb, o_sh, o_ss;
    int64_t hq, hkv, sq, sk;
    int d;
    int causal;
    int64_t window;  // < 0: none
    int64_t kv_len;  // already clamped to sk
    int64_t q_offset;
    float scale_log2;  // sm_scale * log2(e)
    Dims qd, kd, vd;
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// One 4-d TMA box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// Coordinates (col, row, head, batch) placed where the map's dims are.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, Dims dims, int col,
                                         int row, int head, int batch) {
    auto at = [&](int i) {
        return dims.s == i ? row : dims.h == i ? head : batch;
    };
    tma_load(dst, map, bar, col, at(1), at(2), at(3));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type
// 1); addresses and offsets in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
           static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
           static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma m64nNk16, float32 += bf16 x bf16.  ss: A and B from shared memory,
// both K-major (imm-trans 0, 0); scale_d == 0 overwrites the accumulator.
// rs: A from registers, B from shared memory with the transpose bit
// (imm-trans-b 1: B is MN-major), accumulating.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
template <int N>
__host__ __device__ constexpr int chunks() {
    return (N + kChunkCols - 1) / kChunkCols;
}

// Dynamic shared memory of one CTA: 1 KB of alignment slack (the swizzle
// atom is 1024 bytes), Q, the K/V ring and the mbarriers.
template <int N>
__host__ __device__ constexpr int smem_bytes() {
    return 1024 + chunks<N>() * kBQ * kRowBytes +
           kStages * 2 * chunks<N>() * kBK * kRowBytes + 8 * (1 + 2 * kStages);
}

// S = Q K^T for one warpgroup's 64 rows: N / 16 k-steps of wgmma
// m64n64k16, both operands K-major in shared memory (the columns past D are
// TMA's zeros); k-step kk reads 16 columns, 32 bytes into chunk kk / 4.
template <int N>
__device__ __forceinline__ void qk(float (&s)[kBK / 2], uint32_t q,
                                   uint32_t k) {
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        const uint32_t qa = q + (kk / 4) * kQChunk + col;
        const uint32_t ka = k + (kk / 4) * kKVChunk + col;
        wgmma_ss_n64(s, desc(qa, 16, 1024), desc(ka, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
}

// ot = sum over the parts of P_part V for one 64-key tile: k-step kk reads
// keys [16 kk, 16 kk + 16) of the V tile (V is MN-major: the transpose
// bit), whose 64-column chunks sit kKVChunk bytes apart; the first
// product overwrites ot.
template <int N>
__device__ __forceinline__ void pv(float (&ot)[N / 2],
                                   const uint32_t (&pa)[kParts][kBK / 4],
                                   uint32_t v) {
    fence_regs(ot);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t vd = desc(v + kk * 16 * kRowBytes, kKVChunk, 1024);
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
            const uint32_t a[4] = {pa[part][4 * kk], pa[part][4 * kk + 1],
                                   pa[part][4 * kk + 2], pa[part][4 * kk + 3]};
            wgmma_rs(ot, a, vd, kk > 0 || part > 0);
        }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(ot);
}

// N: the P V product's width, the head dim rounded up to 64, 96 or 128.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
    constexpr int kChunks = chunks<N>();
    constexpr int kStageBytes = 2 * kChunks * kKVChunk;  // K chunks, V chunks
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t s_q = base;
    const uint32_t s_kv = s_q + kChunks * kQChunk;
    const uint32_t bars = s_kv + kStages * kStageBytes;
    const uint32_t q_full = bars;
    auto full = [&](int s) { return bars + 8u * (1 + s); };
    auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

    const int64_t bh = blockIdx.x;
    const int64_t b = bh / p.hq, h = bh - b * p.hq;
    const int64_t hk = h / (p.hq / p.hkv);
    // heaviest (latest) query blocks first: causal load balance
    const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
    // the key blocks some row of this CTA sees
    int64_t kb_lo = 0, kb_hi = (p.kv_len + kBK - 1) / kBK;
    if (p.causal) {
        const int64_t last = p.q_offset + imin(q0 + kBQ - 1, p.sq - 1);
        kb_hi = last < 0 ? 0 : imin(kb_hi, last / kBK + 1);
    }
    if (p.window >= 0) {
        const int64_t first = p.q_offset + q0 - p.window + 1;
        if (first > 0) kb_lo = first / kBK;
    }

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), kConsumers / 32);  // one arrival a warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // one branch per role, never reconverging, so that setmaxnreg holds
    if (threadIdx.x >= kConsumers) {
        // producer warpgroup: gives its registers to the consumers; one
        // thread issues every TMA load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (threadIdx.x != kConsumers) return;
        mbar_expect_tx(q_full, kChunks * kQChunk);
        for (int c = 0; c < kChunks; ++c)
            tma_tile(s_q + c * kQChunk, &tq, q_full, p.qd, c * kChunkCols,
                     (int)q0, (int)h, (int)b);
        int it = 0;
        for (int64_t kb = kb_lo; kb < kb_hi; ++kb, ++it) {
            const int s = it % kStages;
            // stage s is free once both warpgroups used its last tiles
            if (it >= kStages) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
            const uint32_t dst = s_kv + s * kStageBytes;
            mbar_expect_tx(full(s), kStageBytes);
            for (int c = 0; c < kChunks; ++c) {
                tma_tile(dst + c * kKVChunk, &tk, full(s), p.kd,
                         c * kChunkCols, (int)(kb * kBK), (int)hk, (int)b);
                tma_tile(dst + (kChunks + c) * kKVChunk, &tv, full(s), p.vd,
                         c * kChunkCols, (int)(kb * kBK), (int)hk, (int)b);
            }
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    // consumer warpgroup wg owns rows [row0, row0 + 64) of the CTA; this
    // thread holds rows r_lo and r_lo + 8 of its accumulators, and in them
    // element i sits at row r_lo + 8 * (i / 2 % 2), column 8 * (i / 4) +
    // col_base + i % 2
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int64_t row0 = q0 + 64 * wg;
    const int64_t r_lo = row0 + 16 * warp + lane / 4;
    const int64_t pos_lo = p.q_offset + r_lo, pos_hi = pos_lo + 8;
    const bool active = row0 < p.sq;
    const int64_t pos_min = p.q_offset + row0;
    const int64_t pos_max = p.q_offset + imin(row0 + 63, p.sq - 1);
    const int col_base = (lane & 3) * 2;

    float o[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) o[i] = 0.0f;
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;

    mbar_wait(q_full, 0);
    const uint32_t q_base = s_q + wg * 64 * kRowBytes;
    int it = 0;
    for (int64_t kb = kb_lo; kb < kb_hi; ++kb, ++it) {
        const int s = it % kStages;
        mbar_wait(full(s), (it / kStages) & 1);
        const int64_t kpos0 = kb * kBK;
        // a block fully masked for this warpgroup's rows is skipped
        const bool skip =
            !active || (p.causal && kpos0 > pos_max) ||
            (p.window >= 0 && pos_min - (kpos0 + kBK - 1) >= p.window);
        if (!skip) {
            const uint32_t k_base = s_kv + s * kStageBytes;
            float sc[kBK / 2];
            qk<N>(sc, q_base, k_base);

            // masks, only on a block some of whose keys a row cannot see
            const bool whole = kpos0 + kBK - 1 < p.kv_len &&
                               (!p.causal || kpos0 + kBK - 1 <= pos_min) &&
                               (p.window < 0 || pos_max - kpos0 < p.window);
            uint32_t allow = 0xffffffffu;
            if (!whole) {
                allow = 0u;
#pragma unroll
                for (int i = 0; i < kBK / 2; ++i) {
                    const int64_t col =
                        kpos0 + (i / 4) * 8 + col_base + (i & 1);
                    const int64_t pos = (i & 2) ? pos_hi : pos_lo;
                    const bool ok = col < p.kv_len &&
                                    (!p.causal || col <= pos) &&
                                    (p.window < 0 || pos - col < p.window);
                    allow |= static_cast<uint32_t>(ok) << i;
                }
            }
            // online softmax: the four lanes of a quad share a row
            float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
            for (int i = 0; i < kBK / 2; ++i) {
                sc[i] = (allow >> i & 1u) ? sc[i] * p.scale_log2 : kNegInf;
                if (i & 2) mx_hi = fmaxf(mx_hi, sc[i]);
                else mx_lo = fmaxf(mx_lo, sc[i]);
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx_lo = fmaxf(mx_lo, __shfl_xor_sync(~0u, mx_lo, off));
                mx_hi = fmaxf(mx_hi, __shfl_xor_sync(~0u, mx_hi, off));
            }
            const float mn_lo = fmaxf(m_lo, mx_lo);
            const float mn_hi = fmaxf(m_hi, mx_hi);
            const float a_lo = exp2f(m_lo - mn_lo);
            const float a_hi = exp2f(m_hi - mn_hi);
            m_lo = mn_lo;
            m_hi = mn_hi;

            // P split into kParts bf16 terms, each the rounded remainder of
            // the ones before, packed as wgmma's A fragments: pa[part][4 kk
            // .. 4 kk + 3] are keys [16 kk, 16 kk + 16) of the two rows
            uint32_t pa[kParts][kBK / 4];
            float rs_lo = 0.0f, rs_hi = 0.0f;  // l sums the float32 P
#pragma unroll
            for (int j = 0; j < kBK / 4; ++j) {
                const float mn = (j & 1) ? mn_hi : mn_lo;
                float r0 = (allow >> (2 * j) & 1u) ? exp2f(sc[2 * j] - mn)
                                                   : 0.0f;
                float r1 = (allow >> (2 * j + 1) & 1u)
                               ? exp2f(sc[2 * j + 1] - mn)
                               : 0.0f;
                if (j & 1) rs_hi += r0 + r1;
                else rs_lo += r0 + r1;
#pragma unroll
                for (int part = 0; part < kParts; ++part) {
                    const __nv_bfloat162 t = __floats2bfloat162_rn(r0, r1);
                    pa[part][j] = *reinterpret_cast<const uint32_t*>(&t);
                    r0 -= __low2float(t);
                    r1 -= __high2float(t);
                }
            }
            l_lo = l_lo * a_lo + rs_lo;
            l_hi = l_hi * a_hi + rs_hi;

            // O = alpha O + P V, the tile's P V from the tensor cores, the
            // sum in float32 rounded to nearest
            float ot[N / 2];
            pv<N>(ot, pa, k_base + kChunks * kKVChunk);
#pragma unroll
            for (int i = 0; i < N / 2; ++i)
                o[i] = fmaf(o[i], (i & 2) ? a_hi : a_lo, ot[i]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
    }

    if (!active) return;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(~0u, l_lo, off);
        l_hi += __shfl_xor_sync(~0u, l_hi, off);
    }
    __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
        const int col = (i / 4) * 8 + col_base;
        const int64_t row = (i & 2) ? r_lo + 8 : r_lo;
        const float l = (i & 2) ? l_hi : l_lo;
        if (row < p.sq && col < p.d) {
            const float inv = l > 0.0f ? 1.0f / l : 0.0f;
            const float x0 = l > 0.0f ? o[i] * inv : 0.0f;
            const float x1 = l > 0.0f ? o[i + 1] * inv : 0.0f;
            *reinterpret_cast<__nv_bfloat162*>(out + row * p.o_ss + col) =
                __floats2bfloat162_rn(x0, x1);
        }
    }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from libcuda.so.1, which PyTorch has loaded.
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
        return lib == nullptr ? nullptr
                              : reinterpret_cast<EncodeTiled>(
                                    dlsym(lib, "cuTensorMapEncodeTiled"));
    }();
    return fn;
}

// A (batch, heads, rows, d) bf16 view with element strides (sb, sh, ss) as
// a 4-d tensor map with a box of 64 columns x box_rows rows, swizzled 128B.
// The outer dimensions go in order of stride; a dimension of size 1 gets a
// stride past the others' extent (any stride reads it right).
cudaError_t encode(CUtensorMap* map, Dims* dims, const void* ptr, int64_t nb,
                   int64_t nh, int64_t ns, int d, int64_t sb, int64_t sh,
                   int64_t ss, int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    struct Outer {
        uint64_t size, stride;
        int which;  // 0 rows, 1 heads, 2 batch
        uint32_t box;
    };
    Outer outer[3] = {{(uint64_t)ns, (uint64_t)ss * 2, 0, (uint32_t)box_rows},
                      {(uint64_t)nh, (uint64_t)sh * 2, 1, 1u},
                      {(uint64_t)nb, (uint64_t)sb * 2, 2, 1u}};
    uint64_t extent = (uint64_t)d * 2;
    for (const Outer& x : outer)
        if (x.size > 1 && x.size * x.stride > extent)
            extent = x.size * x.stride;
    extent = (extent + 15) & ~uint64_t(15);
    for (Outer& x : outer)
        if (x.size <= 1) {
            x.size = 1;
            x.stride = extent;
        }
    for (int i = 1; i < 3; ++i)  // insertion sort by stride
        for (int j = i; j > 0 && outer[j].stride < outer[j - 1].stride; --j) {
            const Outer t = outer[j];
            outer[j] = outer[j - 1];
            outer[j - 1] = t;
        }
    cuuint64_t gdim[4] = {(cuuint64_t)d, outer[0].size, outer[1].size,
                          outer[2].size};
    cuuint64_t gstride[3] = {outer[0].stride, outer[1].stride, outer[2].stride};
    cuuint32_t box[4] = {(cuuint32_t)kChunkCols, outer[0].box, outer[1].box,
                         outer[2].box};
    cuuint32_t estride[4] = {1, 1, 1, 1};
    for (int i = 0; i < 3; ++i) {
        int* slot = outer[i].which == 0 ? &dims->s
                    : outer[i].which == 1 ? &dims->h : &dims->b;
        *slot = i + 1;
    }
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), gdim, gstride, box, estride,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int64_t bh,
                   cudaStream_t stream) {
    constexpr int bytes = smem_bytes<N>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(bh),
                    static_cast<unsigned>((p.sq + kBQ - 1) / kBQ));
    flash_fwd_sm90<N><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

}  // namespace

// bfloat16 only.  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o (B, Hq, Sq, D),
// each given by its element strides of (batch, head, sequence); the last
// dimension is contiguous, the bases 16-byte aligned and the strides of
// q, k and v (of dimensions longer than 1) multiples of 8 elements.
// window < 0 means none; kv_len <= Sk.  The wrapper checks D (a multiple
// of 8, at most 128), Hq % Hkv == 0, the alignment and the grid limits.
HPTMT_API int hptmt_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, int64_t batch,
    int64_t hq, int64_t hkv, int64_t sq, int64_t sk, int d, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int causal, int64_t window, int64_t kv_len,
    int64_t q_offset, float sm_scale, void* stream) {
    if (batch * hq == 0 || sq == 0) return cudaSuccess;
    if (d < 8 || d > 128 || d % 8) return cudaErrorInvalidValue;
    Params p{static_cast<__nv_bfloat16*>(o), o_sb, o_sh, o_ss, hq, hkv, sq,
             sk, d, causal, window, kv_len, q_offset, sm_scale * kLog2e,
             {}, {}, {}};
    CUtensorMap tq, tk, tv;
    const int64_t rows = sk > 0 ? sk : 1;  // no key is read when sk == 0
    cudaError_t err = encode(&tq, &p.qd, q, batch, hq, sq, d, q_sb, q_sh,
                             q_ss, kBQ);
    if (err == cudaSuccess)
        err = encode(&tk, &p.kd, k, batch, hkv, rows, d, k_sb, k_sh, k_ss, kBK);
    if (err == cudaSuccess)
        err = encode(&tv, &p.vd, v, batch, hkv, rows, d, v_sb, v_sh, v_ss, kBK);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto s = static_cast<cudaStream_t>(stream);
    const int64_t bh = batch * hq;
    err = d <= 64   ? launch<64>(tq, tk, tv, p, bh, s)
          : d <= 96 ? launch<96>(tq, tk, tv, p, bh, s)
                    : launch<128>(tq, tk, tv, p, bh, s);
    return static_cast<int>(err);
}
