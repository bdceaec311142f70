// Additive low-rank splat deposit for Hopper (sm_90a), the port's kernel K2.
//
// Replaces the TPU kernel topsy_tpu/ops/splat_pallas.py
// accumulate_groups_pallas (_make_kernel / _group_body / _deposit /
// _profiles_lanes).  For every active group of G particles it adds
//
//   atlas[c, w0 + r, cbase + w] += sum_k sum_i bf16(P_k[r, i] * coef_c[i])
//                                             * bf16(Q_k[w, i])
//
// over exactly rows [0, rows_eval) and columns [0, cols_eval) of the flag's
// size class, with f32 accumulation.  P and Q are the rank-2, degree-6
// profile polynomials of min(d^2 ih^2, 4) (rank signs on P); tiny splats
// (ih < 0) use the cloud-in-cell hat, MASKED groups truncate at
// -FOOT < d <= FOOT, ALL_TINY groups are hat x hat.
//
// What bounds it on the H100: profile evaluation (a degree-6 Horner per
// (row or column) x particle x rank) and the f32 atomics that merge each
// group's tile into the atlas; the bf16 products themselves are small
// (M = C * rows <= 192, N <= 128, K = 2 * G).  Design: one CTA per
// (group, 64-column tile); the group's particles stream through shared
// memory in chunks of 32, the CTA stages bf16(P * coef) for all C * rows
// and bf16(Q) for its 64 columns, multiplies them with bf16 WMMA into f32
// register accumulators, and finally atomically adds the nonzero entries of
// the tile into the atlas (the 23 MB atlas at 1024^2 stays in the 50 MB
// L2).  Inactive groups return at once.  Compile with --fmad=false so the
// profile arithmetic rounds as the plain PyTorch version does (the Horner
// steps are explicit fmaf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int RANK = 2;
constexpr int NCOEF = 7;            // degree-6 profile polynomials
constexpr int PC = 32;              // particles per K chunk
constexpr int KC = RANK * PC;       // K-chunk depth (64)
constexpr int TW = 64;              // atlas columns per CTA
constexpr int NT = TW / 16;         // 16-wide column tiles per CTA
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_C = 4;
constexpr int MAXT = 12;            // accumulator tiles per warp

constexpr int FLAG_ALL_TINY = 1;
constexpr int FLAG_POLY = 2;
constexpr int FLAG_MIXED = 3;
constexpr int FLAG_MASKED = 4;
constexpr int FULL_CLASS = 3;

__constant__ int kSizeRows[3] = {16, 32, 48};
__constant__ int kSizeCols[3] = {32, 64, 128};

struct Params {
    const float* ay;
    const float* ax;
    const float* ih;
    const float* coef;
    long long coef_cstride;
    const int* w0;
    const int* c0;
    const int* ce;
    const int* flags;
    float* atlas;
    int G, C, atlas_rows, atlas_cols, window_rows, profile_cols, rolled;
    float foot;
    float lrk[RANK * NCOEF];  // highest power first
    float signs[RANK];
};

// fused multiply-add per Horner step, as XLA compiles the reference's
// acc * t2 + c (the plain PyTorch version rounds each step the same way)
__device__ __forceinline__ float horner(const float* c, float t) {
    float acc = c[0];
#pragma unroll
    for (int j = 1; j < NCOEF; ++j) acc = fmaf(acc, t, c[j]);
    return acc;
}

// rank profiles at offset d for one particle (signed for rows)
__device__ __forceinline__ void profiles(const Params& p, int kind, float d,
                                         float ih, bool signed_, float out[RANK]) {
    if (kind == FLAG_ALL_TINY) {
        out[0] = fmaxf(0.f, 1.f - fabsf(d));
        out[1] = 0.f;
        return;
    }
    const float ih2 = ih * ih;
    const float t2 = fminf(d * d * ih2, 4.f);
#pragma unroll
    for (int k = 0; k < RANK; ++k) {
        out[k] = horner(p.lrk + k * NCOEF, t2);
        if (signed_) out[k] = out[k] * p.signs[k];
    }
    if ((kind == FLAG_MIXED || kind == FLAG_MASKED) && ih < 0.f) {
        out[0] = fmaxf(0.f, 1.f - sqrtf(fmaxf(t2, 0.f)));
        out[1] = 0.f;
    }
    if (kind == FLAG_MASKED) {
        const float m = (d > -p.foot && d <= p.foot) ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < RANK; ++k) out[k] = out[k] * m;
    }
}

__global__ void __launch_bounds__(THREADS)
accumulate_groups_kernel(Params p) {
    const int g = blockIdx.x;
    const int flag = p.flags[g];
    const int kind = flag >> 2;
    const int sz = flag & 3;
    if (kind < FLAG_ALL_TINY || kind > FLAG_MASKED) return;
    // the reference dispatches size classes only for ALL_TINY / POLY groups
    // of rolled (window-anchored) launches; any other pairing deposits
    // nothing there, and nothing here
    const bool sized = p.rolled && (kind == FLAG_ALL_TINY || kind == FLAG_POLY);
    if (sz != FULL_CLASS && !sized) return;
    const int rows_eval = sz == FULL_CLASS ? p.window_rows
                                           : min(kSizeRows[sz], p.window_rows);
    const int cols_eval = sz == FULL_CLASS ? p.profile_cols
                                           : min(kSizeCols[sz], p.profile_cols);
    const int col0 = blockIdx.y * TW;
    if (col0 >= cols_eval) return;

    const int RP = (rows_eval + 15) & ~15;
    const int M = p.C * RP;
    const int T = (M / 16) * NT;
    const int w0 = p.w0[g];
    const int cbase = p.rolled ? p.ce[g] : p.c0[g];

    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // M x KC
    __nv_bfloat16* Bs = As + M * KC;                               // TW x KC
    float* part = reinterpret_cast<float*>(Bs + TW * KC);          // (3+C) x PC
    float* outs = reinterpret_cast<float*>(smem);                  // M x TW

    const int warp = threadIdx.x >> 5;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXT];
#pragma unroll
    for (int j = 0; j < MAXT; ++j) wmma::fill_fragment(acc[j], 0.f);

    const long long gbase = static_cast<long long>(g) * p.G;
    for (int p0 = 0; p0 < p.G; p0 += PC) {
        __syncthreads();
        if (threadIdx.x < PC) {
            const int i = threadIdx.x;
            const bool ok = p0 + i < p.G;
            const long long off = gbase + p0 + i;
            part[i] = ok ? p.ay[off] : 0.f;
            part[PC + i] = ok ? p.ax[off] : 0.f;
            part[2 * PC + i] = ok ? p.ih[off] : 1.f;
            for (int c = 0; c < p.C; ++c)
                part[(3 + c) * PC + i] = ok ? p.coef[c * p.coef_cstride + off] : 0.f;
        }
        __syncthreads();

        for (int idx = threadIdx.x; idx < RP * PC; idx += THREADS) {
            const int r = idx / PC, i = idx % PC;
            float pr[RANK] = {0.f, 0.f};
            if (r < rows_eval && p0 + i < p.G) {
                const float dy = static_cast<float>(w0 + r) - part[i];
                profiles(p, kind, dy, part[2 * PC + i], true, pr);
            }
            for (int c = 0; c < p.C; ++c) {
                const float cf = part[(3 + c) * PC + i];
#pragma unroll
                for (int k = 0; k < RANK; ++k)
                    As[(c * RP + r) * KC + k * PC + i] = __float2bfloat16(pr[k] * cf);
            }
        }
        for (int idx = threadIdx.x; idx < TW * PC; idx += THREADS) {
            const int w = idx / PC, i = idx % PC;
            float q[RANK] = {0.f, 0.f};
            if (col0 + w < cols_eval && p0 + i < p.G) {
                const float dx = static_cast<float>(cbase + col0 + w) - part[PC + i];
                profiles(p, kind, dx, part[2 * PC + i], false, q);
            }
#pragma unroll
            for (int k = 0; k < RANK; ++k)
                Bs[w * KC + k * PC + i] = __float2bfloat16(q[k]);
        }
        __syncthreads();

#pragma unroll
        for (int j = 0; j < MAXT; ++j) {
            const int t = warp + j * WARPS;
            if (t < T) {
                const int mi = t / NT, ni = t % NT;
#pragma unroll
                for (int kk = 0; kk < KC; kk += 16) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                   wmma::row_major> a;
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                   wmma::col_major> b;
                    wmma::load_matrix_sync(a, As + mi * 16 * KC + kk, KC);
                    wmma::load_matrix_sync(b, Bs + ni * 16 * KC + kk, KC);
                    wmma::mma_sync(acc[j], a, b, acc[j]);
                }
            }
        }
    }

    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
        const int t = warp + j * WARPS;
        if (t < T) {
            const int mi = t / NT, ni = t % NT;
            wmma::store_matrix_sync(outs + mi * 16 * TW + ni * 16, acc[j], TW,
                                    wmma::mem_row_major);
        }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < M * TW; idx += THREADS) {
        const int m = idx / TW, w = idx % TW;
        const int c = m / RP, r = m % RP;
        if (r >= rows_eval || col0 + w >= cols_eval) continue;
        const float v = outs[idx];
        if (v == 0.f) continue;
        const int row = w0 + r, col = cbase + col0 + w;
        if (row < 0 || row >= p.atlas_rows || col < 0 || col >= p.atlas_cols)
            continue;
        atomicAdd(p.atlas + (static_cast<long long>(c) * p.atlas_rows + row)
                                * p.atlas_cols + col, v);
    }
}

}  // namespace

// Launch on ``stream``; returns the cudaError_t of the launch (0 = ok).
extern "C" int topsy_accumulate_groups(
        const float* ay, const float* ax, const float* ih, const float* coef,
        long long coef_cstride, const int* w0, const int* c0, const int* ce,
        const int* flags, float* atlas, int n_groups, int G, int C,
        int atlas_rows, int atlas_cols, int window_rows, int profile_cols,
        int rolled, float foot, const float* lrk_coeffs, const float* signs,
        void* stream) {
    if (n_groups <= 0) return 0;
    const int rp = (window_rows + 15) & ~15;
    const int m_max = C * rp;
    if (C < 1 || C > MAX_C || G < 1 || (m_max / 16) * NT > MAXT * WARPS)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.ay = ay; p.ax = ax; p.ih = ih; p.coef = coef;
    p.coef_cstride = coef_cstride;
    p.w0 = w0; p.c0 = c0; p.ce = ce; p.flags = flags; p.atlas = atlas;
    p.G = G; p.C = C; p.atlas_rows = atlas_rows; p.atlas_cols = atlas_cols;
    p.window_rows = window_rows; p.profile_cols = profile_cols;
    p.rolled = rolled; p.foot = foot;
    for (int j = 0; j < RANK * NCOEF; ++j) p.lrk[j] = lrk_coeffs[j];
    for (int k = 0; k < RANK; ++k) p.signs[k] = signs[k];

    const size_t staging = static_cast<size_t>(m_max) * KC * 2 + TW * KC * 2
                           + (3 + C) * PC * 4;
    const size_t epilogue = static_cast<size_t>(m_max) * TW * 4;
    const size_t smem = staging > epilogue ? staging : epilogue;
    cudaError_t err = cudaFuncSetAttribute(
        accumulate_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(n_groups, (profile_cols + TW - 1) / TW);
    accumulate_groups_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
