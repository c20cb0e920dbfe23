// Masked online-softmax attention forward (flash attention) for float32,
// on the 32-bit FMA units; GQA-native.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, pallas_call at :134) for
// float32 inputs.  bfloat16 inputs run the tensor-core kernel of
// flash_attention_sm90.cu; float32 stays here because TF32 products would
// not hold the float32 tolerance (2e-4) or the float32 greedy tokens.  The
// TPU kernel walks a sequential grid over key blocks and carries the
// running max, sum and accumulator in VMEM scratch between grid steps;
// here one CTA owns one (batch*head, 64-query block) pair and loops over
// the key blocks itself, keeping the running statistics in registers.
//
// What bounds it on an H100: at the serving shapes (S = 1024, D = 64..128)
// the work is ~4*S*S/2*D operations per head against 4*S*D elements of
// input and output, so the float32 rate (67 TFLOP/s outside the tensor
// cores), not memory, is the bound.  Both products run on the FMA units;
// the design keeps the score tile and the probabilities out of device
// memory (shared memory only), reads every K/V tile once per query block,
// and skips key blocks above the causal diagonal or outside the sliding
// window.
//
// Semantics copied from the Pallas kernel:
//   * initial running max -1e30, alpha = exp(m_prev - m_new), masked
//     probabilities set to 0, rows whose sum l == 0 write 0;
//   * masks on absolute positions: query row i sits at q_offset + i; key j
//     is visible iff j < kv_len, (causal) j <= q_pos, (window) q_pos - j <
//     window;
//   * GQA: query head h of batch b reads kv head h / (Hq / Hkv) of batch b
//     (the TPU index map (bh // hq) * hkv + (bh % hq) // group);
//   * accumulation in float32.
// Inputs may be strided views (the last dimension must be contiguous):
// the model passes q/k/v straight out of a (B, S, H, D) -> (B, H, S, D)
// transpose, and the wrapper allocates the output so that the inverse
// transpose back to (B, S, H*D) is free.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows of one CTA
constexpr int kBK = 64;        // keys of one tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x 4 key columns each
constexpr int kLDP = kBK + 1;  // padded row stride of the probability tile
constexpr float kNegInf = -1e30f;

struct View {
    int64_t sb, sh, ss;  // element strides of batch, head, sequence
};

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    View qv, kv, vv, ov;
    int64_t hq, hkv, sq, sk;
    int d;
    int causal;
    int64_t window;  // < 0: none
    int64_t kv_len;  // already clamped to sk
    int64_t q_offset;
    float sm_scale;
};

// Stage rows [row0, row0 + 64) of one head into shared memory with row
// stride ld; rows at or past n are zero.
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int64_t ss,
                                          int64_t row0, int64_t n, int d) {
    for (int e = threadIdx.x; e < kBQ * d; e += kThreads) {
        const int r = e / d, c = e - r * d;
        const int64_t row = row0 + r;
        dst[r * ld + c] = row < n ? src[row * ss + c] : 0.0f;
    }
}

// DC = ceil(D / 16): output columns held by each thread.
template <int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd(Args a) {
    extern __shared__ float smem[];
    const int d = a.d;
    const int ldq = d + 1;  // odd/4-offset strides keep the tile reads
    const int ldk = d + 1;  // free of bank conflicts
    const int ldv = d;
    float* sq = smem;
    float* sk = sq + kBQ * ldq;
    float* sv = sk + kBK * ldk;
    float* sp = sv + kBK * ldv;

    const int64_t bh = blockIdx.x;
    const int64_t b = bh / a.hq, h = bh - b * a.hq;
    const int64_t hk = h / (a.hq / a.hkv);
    // heaviest (latest) query blocks first: causal load balance
    const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
    const int64_t qpos0 = a.q_offset + q0;

    const float* q = static_cast<const float*>(a.q) + b * a.qv.sb +
                     h * a.qv.sh;
    const float* k = static_cast<const float*>(a.k) + b * a.kv.sb +
                     hk * a.kv.sh;
    const float* v = static_cast<const float*>(a.v) + b * a.vv.sb +
                     hk * a.vv.sh;
    float* o = static_cast<float*>(a.o) + b * a.ov.sb + h * a.ov.sh;

    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    load_tile(sq, ldq, q, a.qv.ss, q0, a.sq, d);

    float m[4], l[4], acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
    }

    const int64_t n_kb = (a.kv_len + kBK - 1) / kBK;
    for (int64_t kb = 0; kb < n_kb; ++kb) {
        const int64_t kpos0 = kb * kBK;
        // whole key block above the diagonal / outside every row's window
        if (a.causal && kpos0 > qpos0 + kBQ - 1) break;
        if (a.window >= 0 && qpos0 - (kpos0 + kBK - 1) >= a.window) continue;

        __syncthreads();  // the previous tile is no longer read
        load_tile(sk, ldk, k, a.kv.ss, kpos0, a.sk, d);
        load_tile(sv, ldv, v, a.vv.ss, kpos0, a.sk, d);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
        for (int e = 0; e < d; ++e) {
            float qa[4], kb4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[i] = sq[(ty * 4 + i) * ldq + e];
#pragma unroll
            for (int j = 0; j < 4; ++j) kb4[j] = sk[(tx + 16 * j) * ldk + e];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb4[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int64_t row = qpos0 + ty * 4 + i;
            bool allow[4];
            float m_cur = kNegInf;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int64_t col = kpos0 + tx + 16 * j;
                allow[j] = col < a.kv_len && (!a.causal || col <= row) &&
                           (a.window < 0 || row - col < a.window);
                s[i][j] = allow[j] ? s[i][j] * a.sm_scale : kNegInf;
                m_cur = fmaxf(m_cur, s[i][j]);
            }
            // the 16 threads of one row are one half-warp
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
            const float m_new = fmaxf(m[i], m_cur);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = allow[j] ? expf(s[i][j] - m_new) : 0.0f;
                sp[(ty * 4 + i) * kLDP + tx + 16 * j] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

        for (int j = 0; j < kBK; ++j) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = sp[(ty * 4 + i) * kLDP + j];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                const int col = tx + 16 * c;
                if (col < d) {
                    const float vj = sv[j * ldv + col];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][c] = fmaf(p[i], vj, acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int64_t row = q0 + ty * 4 + i;
        if (row >= a.sq) continue;
        const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
            const int col = tx + 16 * c;
            if (col < d)
                o[row * a.ov.ss + col] = l[i] > 0.0f ? acc[i][c] * inv : 0.0f;
        }
    }
}

int smem_bytes(int d) {
    return static_cast<int>(sizeof(float)) *
           (kBQ * (d + 1) + kBK * (d + 1) + kBK * d + kBQ * kLDP);
}

template <int DC>
cudaError_t launch(const Args& a, int64_t bh, cudaStream_t stream) {
    const int bytes = smem_bytes(a.d);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(bh),
                    static_cast<unsigned>((a.sq + kBQ - 1) / kBQ));
    flash_fwd<DC><<<grid, kThreads, bytes, stream>>>(a);
    return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int64_t bh, cudaStream_t stream) {
    switch ((a.d + 15) / 16) {
        case 1: return launch<1>(a, bh, stream);
        case 2: return launch<2>(a, bh, stream);
        case 3: return launch<3>(a, bh, stream);
        case 4: return launch<4>(a, bh, stream);
        case 5: return launch<5>(a, bh, stream);
        case 6: return launch<6>(a, bh, stream);
        case 7: return launch<7>(a, bh, stream);
        case 8: return launch<8>(a, bh, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o (B, Hq, Sq, D), each given by
// its element strides of (batch, head, sequence); the last dimension is
// contiguous; float32 only.  window < 0 means none;
// kv_len <= Sk.  The wrapper checks D (a multiple of 8, at most 128),
// Hq % Hkv == 0 and the grid limits.
HPTMT_API int hptmt_flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t batch,
    int64_t hq, int64_t hkv, int64_t sq, int64_t sk, int d, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int causal, int64_t window, int64_t kv_len,
    int64_t q_offset, float sm_scale, void* stream) {
    if (batch * hq == 0 || sq == 0) return cudaSuccess;
    Args a{q, k, v, o,
           {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
           {o_sb, o_sh, o_ss},
           hq, hkv, sq, sk, d, causal, window, kv_len, q_offset, sm_scale};
    auto s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(dispatch(a, batch * hq, s));
}
