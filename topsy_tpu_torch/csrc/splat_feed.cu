// The presorted front end ("feed") for Hopper (sm_90a), the port's kernel K1.
//
// Replaces the TPU kernel topsy_tpu/ops/splat_feed.py splat_feed_pallas
// (_feed_kernel_body).  Over groups [g0, g0 + piece_groups) of the
// transposed presorted layout (per-field (n_groups, G) f32 rows) it
// computes, per particle slot, the projection, the pyramid level, h_eff,
// the norm polynomial, the deposit weight and the giant exclusion, and per
// group the window anchors (row reductions), the fit split, the spill
// count, the size class and the dispatch flags; it writes exactly the
// operands splat_atlas.deposit_calls and kernel K2 consume:
//   out   (3 + 2C, piece_groups, G) f32: ay, ax, ih, cfit[0..C), cspill[0..C)
//   out_i (5, piece_groups) i32: w0, c0, ce, flags, nspill
// The plain PyTorch version is splat_feed_plain (ops/splat_feed.py); this
// kernel rounds as it does, value for value.
//
// What bounds it on the H100: device-memory bytes.  A slot reads 4 + C_in
// (+ mask) floats and writes 3 + 2C; the arithmetic (~60 float32
// operations a slot, with two IEEE divisions) is a tenth of the memory
// time.  So the design is about bytes in flight and registers:
//  - one group row per block of ceil(G / 4) threads rounded up to a warp
//    (128 at G = 512), one block per group; each thread owns 4 adjacent
//    lanes, loaded and stored as one 16-byte vector when G % 4 == 0 and
//    every row is 16-byte aligned, else lane by lane.  Any G up to MAX_G;
//    nothing is padded to a power of two;
//  - a thread issues the loads of all its input rows (x, y, z, h, the
//    values, the mask) before it computes, straight into registers: the
//    hardware keeps several blocks resident per SM, so while some reduce,
//    others' rows are in flight.  Each input row is read from device
//    memory once: the value rows stay in registers for both the cfit and
//    the cspill stores;
//  - the row reductions (the anchors' extents, ih's extremes, the giant
//    flag; then the spill count and the active test) are warp shuffles and
//    one combine over the block's warps in shared memory;
//  - the variant is a template on C_IN, DEPTH, RANGED and HAS_MASK; g0,
//    start, count and every view constant are fields of one by-value
//    parameter struct, so nothing is specialised on their values.
// Output stores use the default cache policy: kernel K2 reads them next
// (streaming stores, __stcs, measured no faster: PERF.md).
//
// Rounding.  Every multiply, add and divide is a separately rounded
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (1 / h_eff the correctly
// rounded __frcp_rn; the build passes --fmad=false), in the plain
// version's order.  min, max and clip propagate NaN as torch.minimum /
// torch.maximum / torch.clamp do (fminf and fmaxf would drop it): they are
// min.NaN / max.NaN, and so are the row extremes, as amin / amax.  The
// float -> int32 casts are cvt.rzi (NaN -> 0, saturating), as
// splat_feed_plain's _to_i32 writes them.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by ops/splat_feed.py's _Scalars (ctypes).  At
// namespace scope: the C entry point takes it, so it must not have internal
// linkage (that would make the entry point a local symbol).
struct FeedScalars {
    long long start, count;   // the particle range (RANGED)
    long long v_cstride;      // floats between value rows of two channels
    float m[12];              // world -> clip rows 0..2
    float ppw, inv_ppw;       // pixels per world unit and its inverse
    float res_half, norm_centre, inv_halfwidth;
    float sentinel_ay, col_pad, foot, giant_h, margin;
    float inv_band, band, w0_top, c0_top, big_th, h_min, h_trunc;
    float bucket_thresh, support;
    float window_rows, profile_cols, inv_col_align, col_align, ce_span;
    float sz_r[3], sz_c[3];
    float norm[13];         // highest power first (NORM_TERMS)
    int g0, piece_groups, G;
    int c_in, depth, ranged, has_mask;
};

namespace {

constexpr int LANES = 4;                    // adjacent lanes per thread
constexpr int MAX_G = 1024;                 // lanes per group row at most
constexpr int MAX_THREADS = MAX_G / LANES;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int NORM_TERMS = 13;              // degree-12 norm polynomial
constexpr int N_SIZE = 3;                   // size classes below the full one
constexpr int FULL_CLASS = 3;
static_assert(sizeof(FeedScalars::norm) == NORM_TERMS * sizeof(float), "norm");

struct FeedArgs {
    FeedScalars s;
    const float *x, *y, *z, *h, *v, *mask, *pg;
    float* out;
    int* out_i;
    int vec;
};

// min.NaN / max.NaN (sm_80+): NaN if either operand is NaN, one instruction
__device__ __forceinline__ float nan_min(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
// torch.clamp(v, lo, hi): NaN in, NaN out
__device__ __forceinline__ float clip(float v, float lo, float hi) {
    return nan_min(nan_max(v, lo), hi);
}

// One row's 4 lanes at ``p`` (lanes [lane0, lane0 + 4)); lanes past G read
// as 0 and are never stored or reduced.
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[LANES],
                                           int lane0, int G, bool vec) {
    if (vec) {
        const float4 q = lane0 < G
            ? __ldg(reinterpret_cast<const float4*>(p))
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
        for (int j = 0; j < LANES; ++j)
            v[j] = lane0 + j < G ? __ldg(p + j) : 0.0f;
    }
}

// One output plane's 4 lanes at ``p``.
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[LANES],
                                            int lane0, int G, bool vec) {
    if (vec) {
        if (lane0 < G)
            *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int j = 0; j < LANES; ++j)
            if (lane0 + j < G) p[j] = v[j];
    }
}

template <int C_IN, bool DEPTH, bool RANGED, bool HAS_MASK>
__global__ void __launch_bounds__(MAX_THREADS)
feed_kernel(const FeedArgs a) {
    constexpr int C = C_IN + (DEPTH ? 1 : 0);
    __shared__ float red_f[MAX_WARPS][6];
    __shared__ int red_i[MAX_WARPS][3];   // any_big; nspill, active bits

    const FeedScalars& s = a.s;
    const int G = s.G, pgn = s.piece_groups, row = blockIdx.x;
    const int threads = blockDim.x, t = threadIdx.x;
    const int warp = t >> 5, nwarps = threads >> 5, wl = t & 31;
    const int lane0 = t * LANES;
    const long long plane = static_cast<long long>(pgn) * G;
    const float lo_clip = -s.margin;

    // the group's table row: [bucket, 2^-lev, 2^lev, row_off, res_l]
    const float* pgr = a.pg + static_cast<long long>(s.g0 + row) * 8;
    const float bucket = __ldg(pgr + 0), inv_lev = __ldg(pgr + 1),
                lev_scale = __ldg(pgr + 2), row_off = __ldg(pgr + 3),
                res_l = __ldg(pgr + 4);

    // every input row's 4 lanes, loaded once, before any use
    const long long src = static_cast<long long>(s.g0 + row) * G + lane0;
    float xs[LANES], ys[LANES], zs[LANES], hs[LANES], mk[LANES];
    float vals[C_IN][LANES];
    load_lanes(a.x + src, xs, lane0, G, a.vec);
    load_lanes(a.y + src, ys, lane0, G, a.vec);
    load_lanes(a.z + src, zs, lane0, G, a.vec);
    load_lanes(a.h + src, hs, lane0, G, a.vec);
#pragma unroll
    for (int c = 0; c < C_IN; ++c)
        load_lanes(a.v + c * s.v_cstride + src, vals[c], lane0, G, a.vec);
    if (HAS_MASK) load_lanes(a.mask + src, mk, lane0, G, a.vec);

    const float hi_clip = __fadd_rn(res_l, s.margin);
    float ay[LANES], ax[LANES], sup[LANES], ih[LANES], w[LANES],
        z01[LANES];
    float lo_r = INFINITY, hi_r = -INFINITY, lo_c = INFINITY,
          hi_c = -INFINITY, ih_max = -INFINITY, ih_min = INFINITY;
    int any_big = 0;
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
        const float x = xs[j], y = ys[j], z = zs[j], h = hs[j];
        const float cxw = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(x, s.m[0]), __fmul_rn(y, s.m[1])),
            __fmul_rn(z, s.m[2])), s.m[3]);
        const float cyw = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(x, s.m[4]), __fmul_rn(y, s.m[5])),
            __fmul_rn(z, s.m[6])), s.m[7]);
        const float zz = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(x, s.m[8]), __fmul_rn(y, s.m[9])),
            __fmul_rn(z, s.m[10])), s.m[11]);
        const float cx = __fsub_rn(__fmul_rn(__fadd_rn(cxw, 1.0f),
                                             s.res_half), 0.5f);
        const float cy = __fsub_rn(__fmul_rn(__fsub_rn(1.0f, cyw),
                                             s.res_half), 0.5f);
        const float h_px = __fmul_rn(h, s.ppw);
        bool visible = zz >= 0.0f && zz <= 1.0f && h_px > 0.0f
                       && h_px <= FLT_MAX;
        if (RANGED) {
            const long long p = static_cast<long long>(s.g0 + row) * G
                                + lane0 + j;
            visible = visible && p >= s.start && p < s.start + s.count;
        }
        if (HAS_MASK) visible = visible && mk[j] > 0.0f;

        const float h_l = __fmul_rn(h_px, inv_lev);
        const bool tiny = h_l < s.h_min;
        const float h_eff = tiny ? 1.0f : clip(h_l, s.h_min, s.h_trunc);
        const float cx_l = __fsub_rn(__fmul_rn(__fadd_rn(cx, 0.5f),
                                               inv_lev), 0.5f);
        const float cy_l = __fsub_rn(__fmul_rn(__fadd_rn(cy, 0.5f),
                                               inv_lev), 0.5f);
        const float hw = __fmul_rn(__fmul_rn(h_eff, lev_scale),
                                   s.inv_ppw);
        const float tt = __fmul_rn(
            __fsub_rn(clip(h_eff, 0.4f, s.h_trunc), s.norm_centre),
            s.inv_halfwidth);
        float acc = s.norm[0];
#pragma unroll
        for (int k = 1; k < NORM_TERMS; ++k)
            acc = __fadd_rn(__fmul_rn(acc, tt), s.norm[k]);
        const float c_norm = tiny ? 1.0f : acc;
        float wj = __fdiv_rn(c_norm, __fmul_rn(hw, hw));
        wj = visible ? wj : 0.0f;
        const bool giant = !tiny && h_l > s.giant_h
                           && bucket >= s.bucket_thresh;
        w[j] = giant ? 0.0f : wj;

        float ayj = __fadd_rn(row_off, clip(cy_l, lo_clip, hi_clip));
        float axj = __fadd_rn(s.col_pad, clip(cx_l, lo_clip, hi_clip));
        ayj = ayj == ayj ? ayj : s.sentinel_ay;
        axj = axj == axj ? axj : s.col_pad;
        ay[j] = ayj;
        ax[j] = axj;
        ih[j] = tiny ? -1.0f : __frcp_rn(h_eff);  // = 1 / h_eff, rounded
        sup[j] = tiny ? 1.0f : nan_min(__fmul_rn(s.support, h_eff),
                                       s.foot);
        z01[j] = zz;
        if (lane0 + j < G) {
            lo_r = nan_min(lo_r, __fsub_rn(ayj, sup[j]));
            hi_r = nan_max(hi_r, __fadd_rn(ayj, sup[j]));
            lo_c = nan_min(lo_c, __fsub_rn(axj, sup[j]));
            hi_c = nan_max(hi_c, __fadd_rn(axj, sup[j]));
            ih_max = nan_max(ih_max, ih[j]);
            ih_min = nan_min(ih_min, ih[j]);
            any_big |= ih[j] > 0.0f && ih[j] < s.big_th;
        }
    }
    // ---- row reduction 1: extents, ih's extremes, the giant flag ----
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        lo_r = nan_min(lo_r, __shfl_xor_sync(0xffffffffu, lo_r, off));
        hi_r = nan_max(hi_r, __shfl_xor_sync(0xffffffffu, hi_r, off));
        lo_c = nan_min(lo_c, __shfl_xor_sync(0xffffffffu, lo_c, off));
        hi_c = nan_max(hi_c, __shfl_xor_sync(0xffffffffu, hi_c, off));
        ih_max = nan_max(ih_max, __shfl_xor_sync(0xffffffffu, ih_max, off));
        ih_min = nan_min(ih_min, __shfl_xor_sync(0xffffffffu, ih_min, off));
    }
    any_big = __reduce_or_sync(0xffffffffu, any_big);
    if (wl == 0) {
        red_f[warp][0] = lo_r; red_f[warp][1] = hi_r;
        red_f[warp][2] = lo_c; red_f[warp][3] = hi_c;
        red_f[warp][4] = ih_max; red_f[warp][5] = ih_min;
        red_i[warp][0] = any_big;
    }
    __syncthreads();
    lo_r = red_f[0][0]; hi_r = red_f[0][1];
    lo_c = red_f[0][2]; hi_c = red_f[0][3];
    ih_max = red_f[0][4]; ih_min = red_f[0][5];
    any_big = red_i[0][0];
    for (int k = 1; k < nwarps; ++k) {
        lo_r = nan_min(lo_r, red_f[k][0]);
        hi_r = nan_max(hi_r, red_f[k][1]);
        lo_c = nan_min(lo_c, red_f[k][2]);
        hi_c = nan_max(hi_c, red_f[k][3]);
        ih_max = nan_max(ih_max, red_f[k][4]);
        ih_min = nan_min(ih_min, red_f[k][5]);
        any_big |= red_i[k][0];
    }

    // ---- the group's window -------------------------------------------
    const float w0f = clip(__fmul_rn(floorf(__fmul_rn(lo_r, s.inv_band)),
                                     s.band), 0.0f, s.w0_top);
    const float ce_raw = floorf(lo_c);
    const float c0f = clip(__fmul_rn(floorf(__fmul_rn(ce_raw,
                                                      s.inv_col_align)),
                                     s.col_align), 0.0f, s.c0_top);
    const float cef = nan_min(nan_max(ce_raw, c0f),
                              __fadd_rn(c0f, s.ce_span));
    const float row_lim = __fadd_rn(w0f, s.window_rows);
    const float col_lim = __fadd_rn(cef, s.profile_cols);

    // ---- coefficients, fit split, stores ------------------------------
    bool fits[LANES];
    float cc[C][LANES];
    int nsp = 0, act = 0;               // act: bit 0 a |cfit| > 0, bit 1 NaN
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
        fits[j] = __fadd_rn(ay[j], sup[j]) < row_lim
                  && __fadd_rn(ax[j], sup[j]) < col_lim
                  && __fsub_rn(ax[j], sup[j]) >= cef;
#pragma unroll
        for (int c = 0; c < C_IN; ++c) cc[c][j] = __fmul_rn(vals[c][j], w[j]);
        if (DEPTH)
            cc[C - 1][j] = __fmul_rn(__fmul_rn(vals[0][j], z01[j]), w[j]);
    }
    float* out = a.out + static_cast<long long>(row) * G + lane0;
    store_lanes(out, ay, lane0, G, a.vec);
    store_lanes(out + plane, ax, lane0, G, a.vec);
    store_lanes(out + 2 * plane, ih, lane0, G, a.vec);
    bool spilled[LANES];
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
        // sum |coef| > 0: no NaN among them and one nonzero
        bool nan_any = false, pos_any = false;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float m = fabsf(cc[c][j]);
            nan_any |= m != m;
            pos_any |= m > 0.0f;
        }
        spilled[j] = !fits[j] && !nan_any && pos_any;
        if (lane0 + j < G) {
            nsp += spilled[j];
            if (fits[j]) act |= (pos_any ? 1 : 0) | (nan_any ? 2 : 0);
        }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float f[LANES], sp[LANES];
#pragma unroll
        for (int j = 0; j < LANES; ++j) {
            f[j] = fits[j] ? cc[c][j] : 0.0f;
            sp[j] = spilled[j] ? cc[c][j] : 0.0f;
        }
        store_lanes(out + (3 + c) * plane, f, lane0, G, a.vec);
        store_lanes(out + (3 + C + c) * plane, sp, lane0, G, a.vec);
    }

    // ---- row reduction 2: the spill count and the active test --------
    nsp = __reduce_add_sync(0xffffffffu, nsp);
    act = __reduce_or_sync(0xffffffffu, act);
    if (wl == 0) {
        red_i[warp][1] = nsp;
        red_i[warp][2] = act;
    }
    __syncthreads();
    if (t == 0) {
        for (int k = 1; k < nwarps; ++k) {
            nsp += red_i[k][1];
            act |= red_i[k][2];
        }
        int sizes = FULL_CLASS;
#pragma unroll
        for (int sz = N_SIZE - 1; sz >= 0; --sz)
            if (hi_r < __fadd_rn(w0f, s.sz_r[sz])
                && hi_c < __fadd_rn(cef, s.sz_c[sz]))
                sizes = sz;
        const bool active = act == 1;   // a positive sum, no NaN term
        const int kind = !active ? 0
            : ih_max < 0.0f ? 1
            : any_big ? 4
            : ih_min < 0.0f ? 3 : 2;
        const int szc = (kind == 1 || kind == 2) ? sizes : FULL_CLASS;
        int* oi = a.out_i + row;
        oi[0] = __float2int_rz(w0f);
        oi[pgn] = __float2int_rz(c0f);
        oi[2 * pgn] = __float2int_rz(cef);
        oi[3 * pgn] = kind * 4 + szc;
        oi[4 * pgn] = nsp;
    }
}

// One block per group of the piece.
template <int C_IN, bool DEPTH, bool RANGED, bool HAS_MASK>
int launch(const FeedArgs& a, cudaStream_t stream) {
    const int threads = ((a.s.G + LANES - 1) / LANES + 31) / 32 * 32;
    feed_kernel<C_IN, DEPTH, RANGED, HAS_MASK>
        <<<a.s.piece_groups, threads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int C_IN, bool DEPTH>
int launch_rm(const FeedArgs& a, cudaStream_t stream) {
    const bool ranged = a.s.ranged != 0, has_mask = a.s.has_mask != 0;
    if (ranged)
        return has_mask ? launch<C_IN, DEPTH, true, true>(a, stream)
                        : launch<C_IN, DEPTH, true, false>(a, stream);
    return has_mask ? launch<C_IN, DEPTH, false, true>(a, stream)
                    : launch<C_IN, DEPTH, false, false>(a, stream);
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// sizeof(FeedScalars), which the wrapper holds its ctypes mirror to.
extern "C" int topsy_splat_feed_scalars_size() {
    return static_cast<int>(sizeof(FeedScalars));
}

// Launch K1 on ``stream`` over ``s->piece_groups`` groups from ``s->g0``:
// x, y, z, h, mask (n_groups, G), v (C_in, n_groups, G) at a channel
// stride of s->v_cstride floats, pg (n_groups, 8); out (3 + 2C,
// piece_groups, G) f32 and out_i (5, piece_groups) i32.  ``mask`` may be
// null unless s->has_mask.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int topsy_splat_feed(const FeedScalars* s, const float* x,
                                const float* y, const float* z,
                                const float* h, const float* v,
                                const float* mask, const float* pg,
                                float* out, int* out_i, void* stream) {
    if (s->piece_groups <= 0) return 0;
    if (s->G < 1 || s->G > MAX_G || s->c_in < 1 || s->c_in > 3
        || (s->has_mask && mask == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    FeedArgs a;
    a.s = *s;
    a.x = x; a.y = y; a.z = z; a.h = h; a.v = v; a.mask = mask; a.pg = pg;
    a.out = out; a.out_i = out_i;
    a.vec = s->G % LANES == 0 && s->v_cstride % LANES == 0
            && aligned16(x) && aligned16(y) && aligned16(z) && aligned16(h)
            && aligned16(v) && aligned16(out)
            && (!s->has_mask || aligned16(mask));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (s->c_in * 2 + (s->depth ? 1 : 0)) {
    case 2: return launch_rm<1, false>(a, st);
    case 3: return launch_rm<1, true>(a, st);
    case 4: return launch_rm<2, false>(a, st);
    case 5: return launch_rm<2, true>(a, st);
    case 6: return launch_rm<3, false>(a, st);
    default: return launch_rm<3, true>(a, st);
    }
}
