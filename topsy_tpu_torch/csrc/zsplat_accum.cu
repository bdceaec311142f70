// Z-buffered (front-most fragment) splat deposit for Hopper (sm_90a), the
// port's kernel K3.
//
// Replaces the TPU kernel topsy_tpu/ops/zsplat_pallas.py
// accumulate_max_groups_pallas (_make_kernel / _group_body / _max_deposit).
// For every active group of G particles and every pixel (w0 + r, cbase + c)
// of its size class's rectangle [0, rows_eval) x [0, cols_eval) it keeps
// the lexicographic maximum over the group's fragments of (depth, value),
//
//   depth = z01 + sqrt(max(4 - (dy^2 + dx^2) * ih^2, 0)) * h_clip_half
//
// for ih > 0, t > 0 and -FOOT < dy, dx <= FOOT, and merges it into the
// atlas, held as one packed int64 key per pixel (ord(depth) * 2^32 +
// ord(value), ops/zsplat_accum.py pack_atlas), with atomicMax: the
// lexicographic maximum is order-independent, so the result is the
// reference's atlas exactly.
//
// What bounds it on the H100: the float32 work of the fragments, a few
// operations per pixel of a particle's +-8 footprint and a square root per
// hit (t > 0); the bytes (the groups' particles, the hit pixels' keys) are
// far less.  A design that tests every pixel of a class rectangle against
// every particle of its group does 10-3000x that work, most of it on
// pixels outside the particle's footprint.
//
// Design.
//  - A one-block plan kernel sorts the active groups by size class on the
//    card (a stable counting sort, Morton order kept inside a class), so
//    no block is launched for an inactive group; one persistent launch per
//    class, templated on the class's panel (the part of the rectangle whose
//    keys a block holds in shared memory), walks that class's groups.
//  - A block stages its group's 6 x G inputs once (cp.async) and computes
//    each particle's box: the rows and columns where a fragment can hit,
//    decided by the same float32 expressions as the fragment test (dy =
//    fy - ay, -FOOT < dy <= FOOT) and fl(dy^2) * ih^2 < 4, which every hit
//    satisfies (s >= fl(dy^2) and s >= fl(dx^2) in all three summation
//    orders, and t > 0 iff s * ih^2 < 4 exactly), clipped to the rectangle
//    and the atlas.  The rows (and columns) that pass form one interval.
//  - The rectangle is walked in panels; a panel that no box meets is
//    skipped (a full-width tier-2 group visits only the few of its 1,152
//    columns that its particles touch), and only the union of the boxes
//    inside a panel is initialised and flushed.  One warp evaluates one
//    particle's box, 32 pixels at a time, and merges each hit into the
//    panel's keys in shared memory (a 64-bit atomicMax, skipped when the
//    key held is already larger); then every pixel holding a key gets one
//    global 64-bit atomicMax.
//  - The class launch's set-up is cached: the shared-memory limit once per
//    device, the blocks per SM once per (device, shared-memory size).
//
// Rounding: built with --fmad=false; the fused steps are explicit fmaf,
// mirroring the reference's CPU compile (ops/zsplat_accum.py sum_order):
// t = fmaf(-s, ih2, 4), depth = fmaf(k, h_clip_half, z01), and s by the
// per-class order 0 (dy^2 + dx^2), 1 (fmaf(dx, dx, dy^2)) or 2
// (fmaf(dy, dy, dx^2)).  sqrtf is IEEE (no fast math).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <unordered_map>

// A breakdown build (k2_variants.py) switches one part off with
// -DK3_SKIP=1 (the fragment evaluation), 2 (the global merge) or 3 (the
// merge into shared memory: a lane keeps its hits' maximum and merges it
// once per particle); the port's own build defines none.
#ifndef K3_SKIP
#define K3_SKIP 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 2048;
constexpr int MAX_DEVICES = 64;
constexpr int FLAG_ACTIVE = 1;
constexpr int NCLASS = 4;
constexpr int FULL_CLASS = 3;
// anchors at or beyond this magnitude cannot reach an atlas of fewer than
// 2^22 rows and columns (the wrapper checks the atlas)
constexpr float FAR = 8388608.0f;

constexpr int kSizeRows[3] = {16, 32, 48};
constexpr int kSizeCols[3] = {32, 64, 128};

struct Params {
    const float* ay;
    const float* ax;
    const float* ih;
    const float* pay;          // (n_groups, 3, G): z01, h_clip_half, value
    const int* w0;
    const int* c0;
    const int* ce;
    const int* order;          // active groups sorted by class
    const int* class_off;      // (NCLASS + 1) class starts in ``order``
    long long* keys;           // (atlas_rows, atlas_cols)
    int G, gpad, atlas_rows, atlas_cols, rolled, vec_in;
    float foot;
};

__device__ __forceinline__ int sord(float x) {
    const int i = __float_as_int(x + 0.0f);   // -0.0 -> +0.0
    return i >= 0 ? i : i ^ 0x7fffffff;
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
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
}

// The interval [lo, hi] of offsets o in [0, n) from ``base`` (rows from w0
// or columns from cbase) at which particle position ``a`` can hit: atlas
// index base + o in [0, limit), -foot < d <= foot and fl(d^2) * ih2 < 4
// with d = float(base + o) - a.  Candidates: floor(a) - 8 .. floor(a) + 9
// (the footprint holds at most floor(a) - 7 .. floor(a) + 9 after
// rounding).  Empty: lo > hi.
__device__ __forceinline__ int2 hit_interval(float a, float ih2, float foot,
                                             int base, int n, int limit) {
    int lo = INT_MAX, hi = INT_MIN;
    const int k = static_cast<int>(floorf(a));
#pragma unroll
    for (int j = -8; j <= 9; ++j) {
        const int x = k + j, o = x - base;
        const float d = static_cast<float>(x) - a;
        if (o >= 0 && o < n && x >= 0 && x < limit && d > -foot && d <= foot
            && fmaf(-(d * d), ih2, 4.0f) > 0.0f) {
            lo = min(lo, o);
            hi = max(hi, o);
        }
    }
    return make_int2(lo, hi);
}

// Group g's input row f: ay, ax, ih, z01, h_clip_half, value.
__device__ __forceinline__ const float* input_row(const Params& p, int g,
                                                  int f) {
    const long long base = static_cast<long long>(g) * p.G;
    return f == 0 ? p.ay + base : f == 1 ? p.ax + base
         : f == 2 ? p.ih + base : p.pay + 3 * base + (f - 3) * p.G;
}

// Copy group g's six input rows into ``s_in`` at a row stride of gpad
// floats.
__device__ __forceinline__ void stage(const Params& p, int g, float* s_in) {
    if (p.vec_in) {
        const int nv = p.G >> 2;
        for (int idx = threadIdx.x; idx < 6 * nv; idx += THREADS) {
            const int f = idx / nv, v = (idx - f * nv) << 2;
            cp_async16(s_in + f * p.gpad + v, input_row(p, g, f) + v);
        }
    } else {
        for (int idx = threadIdx.x; idx < 6 * p.G; idx += THREADS) {
            const int f = idx / p.G, v = idx - f * p.G;
            cp_async4(s_in + f * p.gpad + v, input_row(p, g, f) + v);
        }
    }
    cp_async_wait_all();
}

// Merge one fragment's key into the panel's key in shared memory.
__device__ __forceinline__ void merge_shared(long long* k, long long key) {
    if (key > *reinterpret_cast<volatile long long*>(k)) atomicMax(k, key);
}

// Evaluate the hits of particle i inside rows [r0, r1] x columns [c0, c1]
// (offsets in the group's rectangle) with the warp's 32 lanes, pixel-major
// inside the box, merging them into the panel keys at (pr0, pc0).
template <int PC>
__device__ __forceinline__ void eval_box(const float* s_in, int gpad, int i,
                                         int r0, int r1, int c0, int c1,
                                         int w0, int cbase, int pr0, int pc0,
                                         int order, long long* s_keys) {
    const int lane = threadIdx.x & 31;
    const float ay = s_in[i], ax = s_in[gpad + i], ih = s_in[2 * gpad + i];
    const float z = s_in[3 * gpad + i], h = s_in[4 * gpad + i];
    const long long vbits =
        static_cast<long long>(sord(s_in[5 * gpad + i])) + 2147483648LL;
    const float ih2 = ih * ih;
    const int nc = c1 - c0 + 1;
    const int n = (r1 - r0 + 1) * nc;
    const float inv = 1.0f / static_cast<float>(nc);
#if K3_SKIP == 3
    long long best = static_cast<long long>(INT64_MIN);
#endif
    for (int idx = lane; idx < n; idx += 32) {
        // exact: (idx + 0.5) / nc is at least 0.5 / nc from an integer
        const int rr = __float2int_rz((static_cast<float>(idx) + 0.5f) * inv);
        const int r = r0 + rr, c = c0 + (idx - rr * nc);
        const float dy = static_cast<float>(w0 + r) - ay;
        const float dx = static_cast<float>(cbase + c) - ax;
        float s;
        if (order == 0) {
            s = dy * dy + dx * dx;
        } else if (order == 1) {
            s = fmaf(dx, dx, dy * dy);
        } else {
            s = fmaf(dy, dy, dx * dx);
        }
        const float t = fmaf(-s, ih2, 4.0f);
        if (t > 0.0f) {
            const float dep = fmaf(sqrtf(t), h, z);
            const long long key =
                static_cast<long long>(sord(dep)) * 4294967296LL + vbits;
#if K3_SKIP == 3
            best = max(best, key);
#else
            merge_shared(s_keys + (r - pr0) * PC + (c - pc0), key);
#endif
        }
    }
#if K3_SKIP == 3
    if (best != static_cast<long long>(INT64_MIN))
        merge_shared(s_keys + (r0 - pr0) * PC + (c0 - pc0), best);
#endif
}

template <int PR, int PC>
__global__ void __launch_bounds__(THREADS)
zdeposit_class_kernel(Params p, int cls, int rows_eval, int cols_eval,
                      int order) {
    const int end = p.class_off[cls + 1];
    int slot = p.class_off[cls] + blockIdx.x;
    if (slot >= end) return;

    extern __shared__ __align__(16) unsigned char smem[];
    long long* s_keys = reinterpret_cast<long long*>(smem);       // PR x PC
    int4* s_box = reinterpret_cast<int4*>(s_keys + PR * PC);      // G
    float* s_in = reinterpret_cast<float*>(s_box + p.G);          // 6 x gpad
    __shared__ int s_u[4];                  // the panel's union of boxes
    const long long none = static_cast<long long>(INT64_MIN);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float foot = p.foot;

    for (; slot < end; slot += gridDim.x) {
        const int g = p.order[slot];
        __syncthreads();                    // the last group is done
        stage(p, g, s_in);
        const int w0 = p.w0[g];
        const int cbase = p.rolled ? p.ce[g] : p.c0[g];
        __syncthreads();
        // each particle's box (x, y: its rows; z, w: its columns)
        for (int i = tid; i < p.G; i += THREADS) {
            const float ay = s_in[i], ax = s_in[p.gpad + i];
            const float ih = s_in[2 * p.gpad + i];
            int4 b = make_int4(1, 0, 1, 0);
            if (ih > 0.0f && fabsf(ay) < FAR && fabsf(ax) < FAR) {
                const float ih2 = ih * ih;
                const int2 rb = hit_interval(ay, ih2, foot, w0, rows_eval,
                                             p.atlas_rows);
                const int2 cb = hit_interval(ax, ih2, foot, cbase, cols_eval,
                                             p.atlas_cols);
                if (rb.x <= rb.y && cb.x <= cb.y)
                    b = make_int4(rb.x, rb.y, cb.x, cb.y);
            }
            s_box[i] = b;
        }

        for (int pr0 = 0; pr0 < rows_eval; pr0 += PR) {
            for (int pc0 = 0; pc0 < cols_eval; pc0 += PC) {
                const int pr1 = pr0 + PR - 1, pc1 = pc0 + PC - 1;
                __syncthreads();            // boxes written, s_u free
                if (tid == 0) {
                    s_u[0] = INT_MAX; s_u[1] = INT_MIN;
                    s_u[2] = INT_MAX; s_u[3] = INT_MIN;
                }
                __syncthreads();
                int u0 = INT_MAX, u1 = INT_MIN, u2 = INT_MAX, u3 = INT_MIN;
                for (int i = tid; i < p.G; i += THREADS) {
                    const int4 b = s_box[i];
                    const int r0 = max(b.x, pr0), r1 = min(b.y, pr1);
                    const int c0 = max(b.z, pc0), c1 = min(b.w, pc1);
                    if (r0 <= r1 && c0 <= c1) {
                        u0 = min(u0, r0); u1 = max(u1, r1);
                        u2 = min(u2, c0); u3 = max(u3, c1);
                    }
                }
                u0 = __reduce_min_sync(0xffffffffu, u0);
                u1 = __reduce_max_sync(0xffffffffu, u1);
                u2 = __reduce_min_sync(0xffffffffu, u2);
                u3 = __reduce_max_sync(0xffffffffu, u3);
                if (lane == 0 && u0 <= u1) {
                    atomicMin(s_u, u0); atomicMax(s_u + 1, u1);
                    atomicMin(s_u + 2, u2); atomicMax(s_u + 3, u3);
                }
                __syncthreads();
                const int y0 = s_u[0], y1 = s_u[1], x0 = s_u[2], x1 = s_u[3];
                if (y0 > y1) continue;      // no box meets this panel
                for (int r = y0 + warp; r <= y1; r += WARPS)
                    for (int c = x0 + lane; c <= x1; c += 32)
                        s_keys[(r - pr0) * PC + (c - pc0)] = none;
                __syncthreads();
                if (K3_SKIP != 1) {
                    for (int i = warp; i < p.G; i += WARPS) {
                        const int4 b = s_box[i];
                        const int r0 = max(b.x, pr0), r1 = min(b.y, pr1);
                        const int c0 = max(b.z, pc0), c1 = min(b.w, pc1);
                        if (r0 <= r1 && c0 <= c1)
                            eval_box<PC>(s_in, p.gpad, i, r0, r1, c0, c1, w0,
                                         cbase, pr0, pc0, order, s_keys);
                    }
                }
                __syncthreads();
                for (int r = y0 + warp; r <= y1; r += WARPS) {
                    long long* row = p.keys
                        + static_cast<long long>(w0 + r) * p.atlas_cols + cbase;
                    for (int c = x0 + lane; c <= x1; c += 32) {
                        const long long key = s_keys[(r - pr0) * PC + (c - pc0)];
                        if (K3_SKIP != 2 && key != none) atomicMax(row + c, key);
                    }
                }
            }
        }
    }
}

// The work list: ``order`` holds the groups that deposit (active, and of a
// size class the launch dispatches: every class in rolled launches, the
// full class otherwise) sorted stably by size class, then the others; class
// k is order[class_off[k] : class_off[k + 1]].  One block: each thread
// counts its consecutive share of the groups per class, a block scan over
// the (class, thread) counts places every share, and each thread writes its
// groups in order (a stable counting sort).
constexpr int PLAN_THREADS = 1024;

__device__ __forceinline__ int plan_class(int f, int rolled) {
    const int sz = f & 3;
    return (f >> 2) == FLAG_ACTIVE && (rolled || sz == FULL_CLASS) ? sz
                                                                  : NCLASS;
}

__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const int* flags, int n, int rolled, int* order, int* class_off) {
    __shared__ int scan[PLAN_THREADS];
    __shared__ int base[NCLASS + 1][PLAN_THREADS];
    const int tid = threadIdx.x;
    const int per = (n + PLAN_THREADS - 1) / PLAN_THREADS;
    const int lo = min(n, tid * per), hi = min(n, lo + per);
    int count[NCLASS + 1] = {0, 0, 0, 0, 0};
    for (int g = lo; g < hi; ++g) ++count[plan_class(flags[g], rolled)];
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
    for (int g = lo; g < hi; ++g) order[next[plan_class(flags[g], rolled)]++] = g;
}

template <int PR, int PC>
int launch_class(const Params& p, int cls, int rows_eval, int cols_eval,
                 int order, int n_groups, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(PR) * PC * sizeof(long long)
                        + static_cast<size_t>(p.G) * sizeof(int4)
                        + static_cast<size_t>(6) * p.gpad * sizeof(float);
    auto kernel = zdeposit_class_kernel<PR, PC>;
    // The set-up is made once per device (the shared-memory limit, for the
    // largest group) and once per (device, shared memory) (blocks per SM):
    // made on every launch it holds the host back.
    constexpr size_t kMaxSmem = static_cast<size_t>(PR) * PC * sizeof(long long)
                                + static_cast<size_t>(MAX_G) * sizeof(int4)
                                + static_cast<size_t>(6) * MAX_G * sizeof(float);
    static std::mutex mu;
    static bool limit_set[MAX_DEVICES] = {};
    static std::unordered_map<size_t, int> cap[MAX_DEVICES];  // SMs x blocks/SM
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    int grid_cap;
    {
        std::lock_guard<std::mutex> lock(mu);
        if (!limit_set[dev]) {
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(kMaxSmem));
            if (err != cudaSuccess) return static_cast<int>(err);
            limit_set[dev] = true;
        }
        auto it = cap[dev].find(smem);
        if (it == cap[dev].end()) {
            int per_sm = 0, sms = 0;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, THREADS, smem);
            if (err == cudaSuccess)
                err = cudaDeviceGetAttribute(
                    &sms, cudaDevAttrMultiProcessorCount, dev);
            if (err != cudaSuccess) return static_cast<int>(err);
            if (per_sm < 1)
                return static_cast<int>(cudaErrorInvalidConfiguration);
            it = cap[dev].emplace(smem, sms * per_sm).first;
        }
        grid_cap = it->second;
    }
    const int grid = n_groups < grid_cap ? n_groups : grid_cap;
    kernel<<<grid, THREADS, smem, stream>>>(p, cls, rows_eval, cols_eval,
                                            order);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The work list of ``topsy_accumulate_max_groups`` (``plan``: n_groups +
// NCLASS + 1 ints, ``order`` then ``class_off``), on ``stream``.
extern "C" int topsy_zdeposit_plan(const int* flags, int n_groups, int rolled,
                                   int* plan, void* stream) {
    if (n_groups <= 0) return 0;
    plan_kernel<<<1, PLAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        flags, n_groups, rolled, plan, plan + n_groups);
    return static_cast<int>(cudaGetLastError());
}

// Plan (into ``plan``, n_groups + NCLASS + 1 ints of scratch) and launch on
// ``stream`` one kernel per size class that can deposit (classes 0-3 for
// rolled launches, the full class otherwise); ``orders`` holds each class's
// summation order in 2 bits.  Returns the first cudaError_t (0 = ok).
extern "C" int topsy_accumulate_max_groups(
        const float* ay, const float* ax, const float* ih, const float* pay,
        const int* w0, const int* c0, const int* ce, const int* flags,
        int* plan, long long* keys, int n_groups, int G, int atlas_rows,
        int atlas_cols, int window_rows, int profile_cols, int rolled,
        int vec_in, int orders, float foot, void* stream) {
    if (n_groups <= 0) return 0;
    if (G < 1 || G > MAX_G || window_rows < 0 || profile_cols < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int err = topsy_zdeposit_plan(flags, n_groups, rolled, plan, stream);
    if (err != 0) return err;
    Params p;
    p.ay = ay; p.ax = ax; p.ih = ih; p.pay = pay;
    p.w0 = w0; p.c0 = c0; p.ce = ce;
    p.order = plan; p.class_off = plan + n_groups; p.keys = keys;
    p.G = G; p.gpad = (G + 3) / 4 * 4;
    p.atlas_rows = atlas_rows; p.atlas_cols = atlas_cols;
    p.rolled = rolled; p.vec_in = vec_in; p.foot = foot;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int cls = rolled ? 0 : FULL_CLASS; cls < NCLASS; ++cls) {
        const int rows_eval = cls == FULL_CLASS || window_rows < kSizeRows[cls]
            ? window_rows : kSizeRows[cls];
        const int cols_eval = cls == FULL_CLASS || profile_cols < kSizeCols[cls]
            ? profile_cols : kSizeCols[cls];
        if (rows_eval < 1) continue;
        const int order = (orders >> (2 * cls)) & 3;
        switch (cls) {
        case 0: err = launch_class<16, 32>(p, cls, rows_eval, cols_eval,
                                           order, n_groups, s); break;
        case 1: err = launch_class<32, 64>(p, cls, rows_eval, cols_eval,
                                           order, n_groups, s); break;
        default: err = launch_class<48, 128>(p, cls, rows_eval, cols_eval,
                                             order, n_groups, s); break;
        }
        if (err != 0) return err;
    }
    return 0;
}
