// Additive low-rank splat deposit for Hopper (sm_90a), the port's kernel K2.
//
// Replaces the TPU kernel topsy_tpu/ops/splat_pallas.py
// accumulate_groups_pallas (_make_kernel / _group_body / _deposit /
// _profiles_lanes).  For every depositing group of G particles it adds
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
// What bounds it on the H100.  Evaluated in float32, the profiles do not
// vanish at the support edge (p_k(4) = -5.96e-8 and -9.09e-7), so every
// entry of a POLY group's rectangle is nonzero: 1.4e8 entries of a 2^24
// main pass, 2.0e8 of spill tier 2, each an f32 atomic in the L2-resident
// atlas (23.4 MB at 1024^2) for a scalar design.  With one float4
// reduction per four entries the atomics no longer show in the time; the
// float32 profile evaluation, (rows + cols) x G x rank degree-6 Horner
// steps per group, takes most of it (PERF.md), although a line outside a
// particle's support only needs the clamped constant.  The bf16 products
// are small (M = C * rows <= 384, N <= 136, K = 2 * G).
//
// Design.  A one-block plan kernel sorts the depositing groups by size
// class (a stable counting sort, so Morton order holds inside a class).
// One persistent launch per class, templated on C and the class's rows and
// columns, walks the class's groups, one group per block at a time:
//  - the group's (3 + C) x G inputs arrive in shared memory by cp.async,
//    the next group's copy overlapping this group's work;
//  - 64-particle chunks (32 at C > 2) of bf16(P * coef) (C * rows x 2 KC)
//    and bf16(Q) (columns x 2 KC) are evaluated eight particles of one line
//    per thread, by code specialised on the group's kind (a template
//    parameter, one switch per chunk), so the eight Horner chains
//    interleave; they are written to shared memory in wgmma's no-swizzle
//    K-major layout, double-buffered, and multiplied by
//    wgmma.m64nNk16 (bf16 -> f32, both operands in shared memory) while the
//    next chunk's profiles are evaluated;
//  - a tile is N = 8 + class columns wide, starting at cbase rounded down
//    to a multiple of 4 (columns outside the rectangle have Q = 0), so the
//    flush is one 16-byte vector reduction (atomicAdd on float4, sm_90) per
//    four neighbouring atlas entries, built from the accumulator registers
//    by one shuffle; all-zero vectors are skipped;
//  - full-width groups (spill tier 2, 96 x 1,152) walk their column tiles
//    in the block; when a group's P fits both stages it is evaluated once.
// Merging consecutive groups that share their window into one flush was
// tried and measured slower (the atomics are no longer the limit and the
// uneven runs unbalance the blocks), so every group flushes alone.
// Compile with --fmad=false so the profile arithmetic rounds as the plain
// PyTorch version does (the Horner steps are explicit fmaf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

// A breakdown build (k2_variants.py) switches one part off with
// -DK2_SKIP=1 (the profile evaluation), 2 (the products) or 3 (the flush);
// the port's own build defines none.
#ifndef K2_SKIP
#define K2_SKIP 0
#endif

namespace {

constexpr int RANK = 2;
constexpr int NCOEF = 7;            // degree-6 profile polynomials
constexpr int MAX_C = 4;
constexpr int MAX_ROWS = 96;        // rows of the full class at most
constexpr int MAX_DEVICES = 64;

constexpr int FLAG_ALL_TINY = 1;
constexpr int FLAG_POLY = 2;
constexpr int FLAG_MIXED = 3;
constexpr int FLAG_MASKED = 4;
constexpr int NCLASS = 4;
constexpr int FULL_CLASS = 3;

constexpr int kSizeRows[3] = {16, 32, 48};
constexpr int kSizeCols[3] = {32, 64, 128};

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
    const int* order;       // depositing groups sorted by class
    const int* class_off;   // (NCLASS + 1) class starts in ``order``
    float* atlas;
    int G, atlas_rows, atlas_cols, rolled, vec_in;
    float foot;
    float lrk[RANK * NCOEF];  // highest power first
    float signs[RANK];
};

// Per (C, class rows RT, tile columns NW): warpgroups, chunk depth, smem.
template <int C, int RT, int NW>
struct Cfg {
    static constexpr int M = C * RT;                 // product rows
    static constexpr int MT = (M + 63) / 64;         // m64 tiles
    static constexpr int WGS = MT < 3 ? MT : 3;      // warpgroups
    static constexpr int TPW = (MT + WGS - 1) / WGS; // m64 tiles per warpgroup
    static constexpr int THREADS = 128 * WGS;
    static constexpr int KC = C <= 2 ? 64 : 32;      // particles per chunk
    static constexpr int KK = RANK * KC;             // chunk depth
    static constexpr int OCT = KC / 8;               // particle octets
    static constexpr int A_ELEMS = MT * 64 * KK;     // one stage of P * coef
    static constexpr int B_ELEMS = NW * KK;          // one stage of Q
    static constexpr size_t FIXED = 2 * static_cast<size_t>(A_ELEMS + B_ELEMS)
                                    * sizeof(__nv_bfloat16);
};

// fused multiply-add per Horner step, as XLA compiles the reference's
// acc * t2 + c (the plain PyTorch version rounds each step the same way)
__device__ __forceinline__ float horner(const float* c, float t) {
    float acc = c[0];
#pragma unroll
    for (int j = 1; j < NCOEF; ++j) acc = fmaf(acc, t, c[j]);
    return acc;
}

// rank profiles at offset d for one particle of a KIND group (signed for
// rows), without branches, so that the compiler can interleave the Horner
// chains of a work item's eight particles
template <int KIND>
__device__ __forceinline__ void profiles(const Params& p, float d, float ih,
                                         bool signed_, float out[RANK]) {
    if constexpr (KIND == FLAG_ALL_TINY) {
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
    if constexpr (KIND == FLAG_MIXED || KIND == FLAG_MASKED) {
        const bool tiny = ih < 0.f;
        out[0] = tiny ? fmaxf(0.f, 1.f - sqrtf(fmaxf(t2, 0.f))) : out[0];
        out[1] = tiny ? 0.f : out[1];
    }
    if constexpr (KIND == FLAG_MASKED) {
        const float m = (d > -p.foot && d <= p.foot) ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < RANK; ++k) out[k] = out[k] * m;
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// Element offset of (row, k) in a K-major operand of depth KK laid out as
// wgmma's no-swizzle core matrices (8 rows x 16 bytes, 128 contiguous
// bytes): core matrices run along K inside an 8-row group, then groups.
template <int KK>
__device__ __forceinline__ int core_offset(int row, int k) {
    return ((row >> 3) * (KK >> 3) + (k >> 3)) * 64 + (row & 7) * 8 + (k & 7);
}

// wgmma shared-memory descriptor, no swizzle: the leading byte offset is the
// step between core matrices along K (128 B), the stride byte offset the
// step between 8-row groups (KK * 16 B).
template <int KK>
__device__ __forceinline__ uint64_t smem_desc(const __nv_bfloat16* ptr) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
    return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
           | (static_cast<uint64_t>(128 >> 4) << 16)
           | (static_cast<uint64_t>((KK * 16) >> 4) << 32);
}

template <int N> struct Wgmma;

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B K-major in shared
// memory, D += A B^T (scale-d = 1: the accumulators start at zero)
template <> struct Wgmma<40> {
    static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
                     "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
                     "%13, %14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1, 0, 0;\n}\n"
                     : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
                       "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                       "+f"(d[18]), "+f"(d[19])
                     : "l"(a), "l"(b), "r"(1));
    }
};

template <> struct Wgmma<72> {
    static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
                     "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
                     "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
                     "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, %36, %37, p, 1, 1, 0, 0;\n}\n"
                     : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
                       "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                       "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                       "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
                       "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                       "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
                       "+f"(d[34]), "+f"(d[35])
                     : "l"(a), "l"(b), "r"(1));
    }
};

template <> struct Wgmma<136> {
    static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
                     "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
                     "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
                     "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
                     "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
                     "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                     "%61, %62, %63, %64, %65, %66, %67}, %68, %69, p, 1, 1, 0, 0;\n}\n"
                     : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                       "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                       "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
                       "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                       "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                       "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
                       "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                       "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
                       "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
                       "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                       "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
                       "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
                       "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
                       "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
                       "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
                       "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
                       "+f"(d[66]), "+f"(d[67])
                     : "l"(a), "l"(b), "r"(1));
    }
};

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// generic-proxy shared-memory writes become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator registers across async wgmma
__device__ __forceinline__ void fence_reg(float& r) {
    asm volatile("" : "+f"(r) :: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy group g's (3 + C) input rows (ay, ax, ih, coef_0..C-1), G floats
// each, into ``dst`` at a row stride of ``gpad`` floats.
template <int C, int THREADS>
__device__ __forceinline__ void stage_inputs(const Params& p, int g,
                                             float* dst, int gpad) {
    const long long base = static_cast<long long>(g) * p.G;
    const float* src[3 + C];
    src[0] = p.ay + base;
    src[1] = p.ax + base;
    src[2] = p.ih + base;
#pragma unroll
    for (int c = 0; c < C; ++c) src[3 + c] = p.coef + c * p.coef_cstride + base;
    if (p.vec_in) {
        const int nv = p.G >> 2;
        for (int idx = threadIdx.x; idx < (3 + C) * nv; idx += THREADS) {
            const int s = idx / nv, v = (idx - s * nv) << 2;
#pragma unroll
            for (int t = 0; t < 3 + C; ++t)
                if (t == s) cp_async16(dst + s * gpad + v, src[t] + v);
        }
    } else {
        for (int idx = threadIdx.x; idx < (3 + C) * p.G; idx += THREADS) {
            const int s = idx / p.G, v = idx - s * p.G;
#pragma unroll
            for (int t = 0; t < 3 + C; ++t)
                if (t == s) cp_async4(dst + s * gpad + v, src[t] + v);
        }
    }
}

// Rows [0, RT) of chunk ``ch``: bf16(P_k[r, i] * coef_c[i]) into A at
// product row c * RT + r, depth k * KC + i (zero past rows_eval and G).
template <int C, int RT, int NW, int KIND>
__device__ __forceinline__ void eval_rows(const Params& p, const float* pin,
                                          int gpad, int ch, int w0,
                                          int rows_eval, __nv_bfloat16* A) {
    using K = Cfg<C, RT, NW>;
    if constexpr (K2_SKIP == 1) return;
    for (int it = threadIdx.x; it < RT * K::OCT; it += K::THREADS) {
        const int r = it % RT, oct = it / RT;
        const int i0 = ch * K::KC + oct * 8;
        const bool live = r < rows_eval;
        const float pos = static_cast<float>(w0 + r);
        float v[RANK][8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            // past G the staged values are stale: computed, then dropped
            const int i = i0 + e;
            float pr[RANK];
            profiles<KIND>(p, pos - pin[i], pin[2 * gpad + i], true, pr);
            const bool ok = live && i < p.G;
            v[0][e] = ok ? pr[0] : 0.f;
            v[1][e] = ok ? pr[1] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float* cf = pin + (3 + c) * gpad;
            float w[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) w[e] = i0 + e < p.G ? cf[i0 + e] : 0.f;
#pragma unroll
            for (int k = 0; k < RANK; ++k) {
                uint4 pk;
                pk.x = pack_bf16(v[k][0] * w[0], v[k][1] * w[1]);
                pk.y = pack_bf16(v[k][2] * w[2], v[k][3] * w[3]);
                pk.z = pack_bf16(v[k][4] * w[4], v[k][5] * w[5]);
                pk.w = pack_bf16(v[k][6] * w[6], v[k][7] * w[7]);
                *reinterpret_cast<uint4*>(
                    A + core_offset<K::KK>(c * RT + r, k * K::KC + oct * 8)) = pk;
            }
        }
    }
}

// Tile columns x0 + [0, NW) of chunk ``ch``: bf16(Q_k[x, i]) into B at row
// x - x0 (zero outside [cbase, cbase + cols_eval) and past G).
template <int C, int RT, int NW, int KIND>
__device__ __forceinline__ void eval_cols(const Params& p, const float* pin,
                                          int gpad, int ch, int x0, int cbase,
                                          int cols_eval, __nv_bfloat16* B) {
    using K = Cfg<C, RT, NW>;
    if constexpr (K2_SKIP == 1) return;
    for (int it = threadIdx.x; it < NW * K::OCT; it += K::THREADS) {
        const int w = it % NW, oct = it / NW;
        const int i0 = ch * K::KC + oct * 8;
        const int x = x0 + w;
        const bool live = x >= cbase && x < cbase + cols_eval;
        const float pos = static_cast<float>(x);
        float v[RANK][8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int i = i0 + e;
            float pr[RANK];
            profiles<KIND>(p, pos - pin[gpad + i], pin[2 * gpad + i], false, pr);
            const bool ok = live && i < p.G;
            v[0][e] = ok ? pr[0] : 0.f;
            v[1][e] = ok ? pr[1] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < RANK; ++k) {
            uint4 pk;
            pk.x = pack_bf16(v[k][0], v[k][1]);
            pk.y = pack_bf16(v[k][2], v[k][3]);
            pk.z = pack_bf16(v[k][4], v[k][5]);
            pk.w = pack_bf16(v[k][6], v[k][7]);
            *reinterpret_cast<uint4*>(
                B + core_offset<K::KK>(w, k * K::KC + oct * 8)) = pk;
        }
    }
}

// One chunk's operands for a group of kind KIND (P only when ``rows``).
template <int C, int RT, int NW, int KIND>
__device__ __forceinline__ void eval_chunk(const Params& p, const float* pin,
                                           int gpad, int ch, bool rows, int w0,
                                           int rows_eval, int x0, int cbase,
                                           int cols_eval, __nv_bfloat16* A,
                                           __nv_bfloat16* B) {
    if (rows) eval_rows<C, RT, NW, KIND>(p, pin, gpad, ch, w0, rows_eval, A);
    eval_cols<C, RT, NW, KIND>(p, pin, gpad, ch, x0, cbase, cols_eval, B);
}

// Add a finished tile to the atlas.  Lanes l and l^1 swap half their
// accumulator pairs, so that each lane holds four neighbouring columns of
// one row (row r or r + 8 of its m64 fragment); one float4 reduction per
// four entries, all-zero vectors skipped, rows and columns clipped.
template <int C, int RT, int NW>
__device__ __forceinline__ void flush_tile(
        const Params& p, float (&acc)[Cfg<C, RT, NW>::TPW][NW / 2], int w0,
        int rows_eval, int x0) {
    using K = Cfg<C, RT, NW>;
    const int tid = threadIdx.x, lane = tid & 31, odd = lane & 1;
    const int colq = 4 * ((lane & 3) >> 1);
#pragma unroll
    for (int t = 0; t < K::TPW; ++t) {
        const int mt = (tid >> 7) + t * K::WGS;
        if (mt >= K::MT) continue;
        const int m = mt * 64 + 16 * ((tid & 127) >> 5) + (lane >> 2) + 8 * odd;
        const int c = m / RT, r = m - c * RT;
        const int row = w0 + r;
        const bool row_ok = m < K::M && r < rows_eval && row >= 0
                            && row < p.atlas_rows;
        float* dst = p.atlas + (static_cast<long long>(c) * p.atlas_rows + row)
                               * p.atlas_cols;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
            const float d0 = acc[t][4 * j], d1 = acc[t][4 * j + 1];
            const float d2 = acc[t][4 * j + 2], d3 = acc[t][4 * j + 3];
            const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d0 : d2, 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d1 : d3, 1);
            const float4 v = odd ? make_float4(r0, r1, d2, d3)
                                 : make_float4(d0, d1, r0, r1);
            const int x = x0 + 8 * j + colq;
            if (K2_SKIP != 3 && row_ok && x >= 0 && x < p.atlas_cols
                && (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f))
                atomicAdd(reinterpret_cast<float4*>(dst + x), v);
        }
    }
}

template <int C, int RT, int NW>
__global__ void __launch_bounds__(Cfg<C, RT, NW>::THREADS, 1)
deposit_class_kernel(Params p, int cls, int rows_eval, int cols_eval) {
    using K = Cfg<C, RT, NW>;
    constexpr int KK = K::KK;
    const int end = p.class_off[cls + 1];
    int slot = p.class_off[cls] + blockIdx.x;
    if (slot >= end) return;

    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][A]
    __nv_bfloat16* Bs = As + 2 * K::A_ELEMS;                      // [2][B]
    float* in = reinterpret_cast<float*>(Bs + 2 * K::B_ELEMS);     // [2][(3+C) gpad]
    const int gpad = (p.G + K::KC - 1) / K::KC * K::KC;
    const int in_stride = (3 + C) * gpad;
    const int nch = gpad / K::KC;
    // a group's P fits both stages: evaluated for its first tile only
    const bool resident = nch <= 2;
    const int wg = threadIdx.x >> 7;

    // product rows past C * RT stay zero
    for (int i = threadIdx.x; i < 2 * K::A_ELEMS / 8; i += K::THREADS)
        reinterpret_cast<uint4*>(As)[i] = make_uint4(0u, 0u, 0u, 0u);
    stage_inputs<C, K::THREADS>(p, p.order[slot], in, gpad);
    cp_async_commit();

    float acc[K::TPW][NW / 2];
    for (int buf = 0; slot < end; slot += gridDim.x, buf ^= 1) {
        cp_async_wait_all();
        __syncthreads();                     // this group's inputs in ``buf``
        if (slot + gridDim.x < end)          // the next group's, meanwhile
            stage_inputs<C, K::THREADS>(p, p.order[slot + gridDim.x],
                                        in + (buf ^ 1) * in_stride, gpad);
        cp_async_commit();
        const int g = p.order[slot];
        const int kind = p.flags[g] >> 2;
        const int w0 = p.w0[g];
        const int cbase = p.rolled ? p.ce[g] : p.c0[g];
        const int a0 = cbase - (((cbase % 4) + 4) % 4);
        const int ntiles = (cbase + cols_eval - a0 + NW - 1) / NW;
        const float* pin = in + buf * in_stride;

        for (int tile = 0; tile < ntiles; ++tile) {
            const int x0 = a0 + tile * NW;
#pragma unroll
            for (int t = 0; t < K::TPW; ++t)
#pragma unroll
                for (int j = 0; j < NW / 2; ++j) acc[t][j] = 0.f;
            for (int ch = 0; ch < nch; ++ch) {
                __nv_bfloat16* A = As + (ch & 1) * K::A_ELEMS;
                __nv_bfloat16* B = Bs + (ch & 1) * K::B_ELEMS;
                __syncthreads();             // no wgmma reads this stage
                const bool rows = !(resident && tile > 0);
                switch (kind) {
                case FLAG_ALL_TINY:
                    eval_chunk<C, RT, NW, FLAG_ALL_TINY>(
                        p, pin, gpad, ch, rows, w0, rows_eval, x0, cbase,
                        cols_eval, A, B);
                    break;
                case FLAG_POLY:
                    eval_chunk<C, RT, NW, FLAG_POLY>(
                        p, pin, gpad, ch, rows, w0, rows_eval, x0, cbase,
                        cols_eval, A, B);
                    break;
                case FLAG_MIXED:
                    eval_chunk<C, RT, NW, FLAG_MIXED>(
                        p, pin, gpad, ch, rows, w0, rows_eval, x0, cbase,
                        cols_eval, A, B);
                    break;
                default:
                    eval_chunk<C, RT, NW, FLAG_MASKED>(
                        p, pin, gpad, ch, rows, w0, rows_eval, x0, cbase,
                        cols_eval, A, B);
                }
                fence_async_shared();
                __syncthreads();

                // this warpgroup's m64 tiles of the product, asynchronously,
                // while the next chunk is evaluated
#pragma unroll
                for (int t = 0; t < K::TPW; ++t)
#pragma unroll
                    for (int j = 0; j < NW / 2; ++j) fence_reg(acc[t][j]);
                wgmma_fence();
#pragma unroll
                for (int t = 0; t < K::TPW; ++t) {
                    const int mt = wg + t * K::WGS;
                    if (K2_SKIP != 2 && mt < K::MT) {
#pragma unroll
                        for (int s = 0; s < KK / 16; ++s)
                            Wgmma<NW>::mma(acc[t],
                                           smem_desc<KK>(A + mt * 64 * KK + s * 128),
                                           smem_desc<KK>(B + s * 128));
                    }
                }
                wgmma_commit();
                wgmma_wait<1>();             // the chunk before is done
#pragma unroll
                for (int t = 0; t < K::TPW; ++t)
#pragma unroll
                    for (int j = 0; j < NW / 2; ++j) fence_reg(acc[t][j]);
            }
            wgmma_wait<0>();
#pragma unroll
            for (int t = 0; t < K::TPW; ++t)
#pragma unroll
                for (int j = 0; j < NW / 2; ++j) fence_reg(acc[t][j]);
            flush_tile<C, RT, NW>(p, acc, w0, rows_eval, x0);
        }
    }
    cp_async_wait_all();
}

// The work list: ``order`` holds the groups that deposit (the reference's
// dispatch rule) sorted stably by size class, then the others; class k is
// order[class_off[k] : class_off[k + 1]].  One block: each thread counts
// its consecutive share of the groups per class, a block scan over the
// (class, thread) counts places every share, and each thread writes its
// groups in order (a stable counting sort).
constexpr int PLAN_THREADS = 1024;

__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const int* flags, int n, int rolled, int* order, int* class_off) {
    __shared__ int scan[PLAN_THREADS];
    __shared__ int base[NCLASS + 1][PLAN_THREADS];
    const int tid = threadIdx.x;
    const int per = (n + PLAN_THREADS - 1) / PLAN_THREADS;
    const int lo = min(n, tid * per), hi = min(n, lo + per);
    int count[NCLASS + 1] = {0, 0, 0, 0, 0};
    for (int g = lo; g < hi; ++g) {
        const int f = flags[g], kind = f >> 2, sz = f & 3;
        const bool dep = kind >= FLAG_ALL_TINY && kind <= FLAG_MASKED
                         && (sz == FULL_CLASS || (rolled && kind <= FLAG_POLY));
        ++count[dep ? sz : NCLASS];
    }
    // exclusive scan over (class, thread), class-major
    int carry = 0;
    for (int k = 0; k <= NCLASS; ++k) {
        scan[tid] = count[k];
        __syncthreads();
        for (int off = 1; off < PLAN_THREADS; off <<= 1) {
            const int add = tid >= off ? scan[tid - off] : 0;
            __syncthreads();
            scan[tid] += add;
            __syncthreads();
        }
        base[k][tid] = carry + scan[tid] - count[k];
        if (tid == 0) class_off[k] = carry;
        carry += scan[PLAN_THREADS - 1];
        __syncthreads();
    }
    int next[NCLASS + 1];
#pragma unroll
    for (int k = 0; k <= NCLASS; ++k) next[k] = base[k][tid];
    for (int g = lo; g < hi; ++g) {
        const int f = flags[g], kind = f >> 2, sz = f & 3;
        const bool dep = kind >= FLAG_ALL_TINY && kind <= FLAG_MASKED
                         && (sz == FULL_CLASS || (rolled && kind <= FLAG_POLY));
        order[next[dep ? sz : NCLASS]++] = g;
    }
}

template <int C, int RT, int NW>
int launch_class(const Params& p, int cls, int rows_eval, int cols_eval,
                 int n_groups, cudaStream_t stream) {
    using K = Cfg<C, RT, NW>;
    const int gpad = (p.G + K::KC - 1) / K::KC * K::KC;
    const size_t smem = K::FIXED
                        + 2 * static_cast<size_t>(3 + C) * gpad * sizeof(float);
    auto kernel = deposit_class_kernel<C, RT, NW>;
    // The set-up (shared-memory limit, blocks per SM) is made once per
    // (device, shared memory): made on every launch, it held the host back
    // (a tier-3 call took 0.175 ms instead of 0.071, PERF.md).
    static std::mutex mu;
    static size_t smem_done[MAX_DEVICES] = {};
    static int cap[MAX_DEVICES] = {};            // SMs x blocks per SM
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    int grid_cap;
    {
        std::lock_guard<std::mutex> lock(mu);
        if (smem_done[dev] != smem) {
            int per_sm = 0, sms = 0;
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err == cudaSuccess)
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, kernel, K::THREADS, smem);
            if (err == cudaSuccess)
                err = cudaDeviceGetAttribute(
                    &sms, cudaDevAttrMultiProcessorCount, dev);
            if (err != cudaSuccess) return static_cast<int>(err);
            if (per_sm < 1)
                return static_cast<int>(cudaErrorInvalidConfiguration);
            smem_done[dev] = smem;
            cap[dev] = sms * per_sm;
        }
        grid_cap = cap[dev];
    }
    const int grid = n_groups < grid_cap ? n_groups : grid_cap;
    kernel<<<grid, K::THREADS, smem, stream>>>(p, cls, rows_eval, cols_eval);
    return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_c(const Params& p, int cls, int rows_eval, int cols_eval,
             int n_groups, cudaStream_t stream) {
    switch (cls) {
    case 0: return launch_class<C, 16, 40>(p, cls, rows_eval, cols_eval,
                                            n_groups, stream);
    case 1: return launch_class<C, 32, 72>(p, cls, rows_eval, cols_eval,
                                            n_groups, stream);
    case 2: return launch_class<C, 48, 136>(p, cls, rows_eval, cols_eval,
                                             n_groups, stream);
    default: return launch_class<C, MAX_ROWS, 136>(p, cls, rows_eval,
                                                    cols_eval, n_groups, stream);
    }
}

}  // namespace

// The work list of ``topsy_accumulate_groups`` (``plan``: n + NCLASS + 1
// ints, ``order`` then ``class_off``), on ``stream``.
extern "C" int topsy_deposit_plan(const int* flags, int n_groups, int rolled,
                                  int* plan, void* stream) {
    if (n_groups <= 0) return 0;
    plan_kernel<<<1, PLAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        flags, n_groups, rolled, plan, plan + n_groups);
    return static_cast<int>(cudaGetLastError());
}

// Plan (into ``plan``, n_groups + NCLASS + 1 ints of scratch) and launch on
// ``stream`` one kernel per size class that can deposit (classes 0-3 for
// rolled launches, the full class otherwise); returns the first cudaError_t
// (0 = ok).
extern "C" int topsy_accumulate_groups(
        const float* ay, const float* ax, const float* ih, const float* coef,
        long long coef_cstride, const int* w0, const int* c0, const int* ce,
        const int* flags, int* plan, float* atlas, int n_groups, int G, int C,
        int atlas_rows, int atlas_cols, int window_rows, int profile_cols,
        int rolled, int vec_in, float foot, const float* lrk_coeffs,
        const float* signs, void* stream) {
    if (n_groups <= 0) return 0;
    if (C < 1 || C > MAX_C || G < 1 || window_rows < 0
        || window_rows > MAX_ROWS || atlas_cols % 4 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int err = topsy_deposit_plan(flags, n_groups, rolled, plan, stream);
    if (err != 0) return err;
    Params p;
    p.ay = ay; p.ax = ax; p.ih = ih; p.coef = coef;
    p.coef_cstride = coef_cstride;
    p.w0 = w0; p.c0 = c0; p.ce = ce; p.flags = flags;
    p.order = plan; p.class_off = plan + n_groups; p.atlas = atlas;
    p.G = G; p.atlas_rows = atlas_rows; p.atlas_cols = atlas_cols;
    p.rolled = rolled; p.vec_in = vec_in; p.foot = foot;
    for (int j = 0; j < RANK * NCOEF; ++j) p.lrk[j] = lrk_coeffs[j];
    for (int k = 0; k < RANK; ++k) p.signs[k] = signs[k];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int cls = rolled ? 0 : FULL_CLASS; cls < NCLASS; ++cls) {
        const int rows_eval = cls == FULL_CLASS || window_rows < kSizeRows[cls]
            ? window_rows : kSizeRows[cls];
        const int cols_eval = cls == FULL_CLASS || profile_cols < kSizeCols[cls]
            ? profile_cols : kSizeCols[cls];
        switch (C) {
        case 1: err = launch_c<1>(p, cls, rows_eval, cols_eval, n_groups, s); break;
        case 2: err = launch_c<2>(p, cls, rows_eval, cols_eval, n_groups, s); break;
        case 3: err = launch_c<3>(p, cls, rows_eval, cols_eval, n_groups, s); break;
        default: err = launch_c<4>(p, cls, rows_eval, cols_eval, n_groups, s); break;
        }
        if (err != 0) return err;
    }
    return 0;
}
