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
// ord(value), ops/zsplat_accum.py pack_atlas), with one atomicMax: the
// lexicographic maximum is order-independent, so the result is the
// reference's atlas exactly.
//
// What bounds it on the H100: the float32 hemisphere evaluations (rows_eval
// x cols_eval x G per active group, about ten operations each).  Design:
// one CTA per (group, 16 x 32 pixel tile of the class rectangle); tiles
// outside the rectangle and inactive groups return at once.  The CTA stages
// the group's particles in shared memory (invalid ones moved off the
// footprint), each thread owns two pixels of one column, tests a particle's
// footprint before the square root, and issues one atomicMax per pixel
// that has a fragment.
//
// Rounding: built with --fmad=false; the fused steps are explicit fmaf,
// mirroring the reference's CPU compile (ops/zsplat_accum.py sum_order):
// t = fmaf(-s, ih2, 4), depth = fmaf(k, h_clip_half, z01), and s by the
// per-class order 0 (dy^2 + dx^2), 1 (fmaf(dx, dx, dy^2)) or 2
// (fmaf(dy, dy, dx^2)).  sqrtf is IEEE (no fast math).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_R = 16;
constexpr int TILE_C = 32;
constexpr int THREADS = 256;        // 32 columns x 8 rows, two rows a thread
constexpr int MAX_G = 2048;
constexpr int FLAG_ACTIVE = 1;
constexpr int FULL_CLASS = 3;

__constant__ int kSizeRows[3] = {16, 32, 48};
__constant__ int kSizeCols[3] = {32, 64, 128};

struct Params {
    const float* ay;
    const float* ax;
    const float* ih;
    const float* pay;          // (n_groups, 3, G): z01, h_clip_half, value
    const int* w0;
    const int* c0;
    const int* ce;
    const int* flags;
    long long* keys;           // (atlas_rows, atlas_cols)
    int G, atlas_rows, atlas_cols, window_rows, profile_cols, rolled;
    int tiles_c;
    int orders;                // 2 bits per size class
    float foot;
};

__device__ __forceinline__ long long sord(float x) {
    const int i = __float_as_int(x + 0.0f);   // -0.0 -> +0.0
    return static_cast<long long>(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ long long pack(float depth, float value) {
    return sord(depth) * 4294967296LL + (sord(value) + 2147483648LL);
}

__device__ __forceinline__ void eval(float dy, float dx, float dx2, float ih2,
                                     float z, float hch, float v, int order,
                                     float foot, long long& best) {
    if (!(dy > -foot && dy <= foot)) return;
    float s;
    if (order == 0) {
        s = dy * dy + dx2;
    } else if (order == 1) {
        s = fmaf(dx, dx, dy * dy);
    } else {
        s = fmaf(dy, dy, dx2);
    }
    const float t = fmaf(-s, ih2, 4.0f);
    if (!(t > 0.0f)) return;
    const float dep = fmaf(sqrtf(t), hch, z);
    const long long key = pack(dep, v);
    if (key > best) best = key;
}

__global__ void __launch_bounds__(THREADS)
accumulate_max_kernel(Params p) {
    const int g = blockIdx.x;
    const int flag = p.flags[g];
    if ((flag >> 2) != FLAG_ACTIVE) return;
    const int sz = flag & 3;
    // the reference dispatches every size class in rolled (window-anchored)
    // launches and only the full class otherwise
    if (!p.rolled && sz != FULL_CLASS) return;
    const int rows_eval = sz == FULL_CLASS ? p.window_rows
                                           : min(kSizeRows[sz], p.window_rows);
    const int cols_eval = sz == FULL_CLASS ? p.profile_cols
                                           : min(kSizeCols[sz], p.profile_cols);
    const int tr = blockIdx.y / p.tiles_c, tc = blockIdx.y % p.tiles_c;
    const int r_tile = tr * TILE_R, c_tile = tc * TILE_C;
    if (r_tile >= rows_eval || c_tile >= cols_eval) return;

    extern __shared__ float smem[];
    float* s_ay = smem;
    float* s_ax = s_ay + p.G;
    float* s_ih2 = s_ax + p.G;
    float* s_z = s_ih2 + p.G;
    float* s_h = s_z + p.G;
    float* s_v = s_h + p.G;
    const long long base = static_cast<long long>(g) * p.G;
    const float* pay = p.pay + 3 * base;
    for (int i = threadIdx.x; i < p.G; i += THREADS) {
        const float ih = p.ih[base + i];
        // an invalid particle (ih <= 0) is moved off every footprint
        s_ay[i] = ih > 0.0f ? p.ay[base + i] : __int_as_float(0x7f800000);
        s_ax[i] = p.ax[base + i];
        s_ih2[i] = ih * ih;
        s_z[i] = pay[i];
        s_h[i] = pay[p.G + i];
        s_v[i] = pay[2 * p.G + i];
    }
    __syncthreads();

    const int col = c_tile + (threadIdx.x & 31);
    const int r_a = r_tile + (threadIdx.x >> 5);
    const int r_b = r_a + 8;
    const int w0 = p.w0[g];
    const int cbase = p.rolled ? p.ce[g] : p.c0[g];
    const int order = (p.orders >> (2 * sz)) & 3;
    const float fx = static_cast<float>(cbase + col);
    const float fy_a = static_cast<float>(w0 + r_a);
    const float fy_b = static_cast<float>(w0 + r_b);
    const long long none = static_cast<long long>(INT64_MIN);
    long long best_a = none, best_b = none;
    if (col < cols_eval) {
        for (int i = 0; i < p.G; ++i) {
            const float dx = fx - s_ax[i];
            if (!(dx > -p.foot && dx <= p.foot)) continue;
            const float dx2 = dx * dx;
            const float ih2 = s_ih2[i], z = s_z[i], h = s_h[i], v = s_v[i];
            const float ay = s_ay[i];
            eval(fy_a - ay, dx, dx2, ih2, z, h, v, order, p.foot, best_a);
            eval(fy_b - ay, dx, dx2, ih2, z, h, v, order, p.foot, best_b);
        }
    }
    const int arow_a = w0 + r_a, arow_b = w0 + r_b, acol = cbase + col;
    const bool col_ok = col < cols_eval && acol >= 0 && acol < p.atlas_cols;
    if (col_ok && best_a != none && r_a < rows_eval && arow_a >= 0
            && arow_a < p.atlas_rows)
        atomicMax(p.keys + static_cast<long long>(arow_a) * p.atlas_cols + acol,
                  best_a);
    if (col_ok && best_b != none && r_b < rows_eval && arow_b >= 0
            && arow_b < p.atlas_rows)
        atomicMax(p.keys + static_cast<long long>(arow_b) * p.atlas_cols + acol,
                  best_b);
}

}  // namespace

// Launch on ``stream``; returns the cudaError_t of the launch (0 = ok).
extern "C" int topsy_accumulate_max_groups(
        const float* ay, const float* ax, const float* ih, const float* pay,
        const int* w0, const int* c0, const int* ce, const int* flags,
        long long* keys, int n_groups, int G, int atlas_rows, int atlas_cols,
        int window_rows, int profile_cols, int rolled, int orders, float foot,
        void* stream) {
    if (n_groups <= 0) return 0;
    if (G < 1 || G > MAX_G || window_rows < 1 || profile_cols < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.ay = ay; p.ax = ax; p.ih = ih; p.pay = pay;
    p.w0 = w0; p.c0 = c0; p.ce = ce; p.flags = flags; p.keys = keys;
    p.G = G; p.atlas_rows = atlas_rows; p.atlas_cols = atlas_cols;
    p.window_rows = window_rows; p.profile_cols = profile_cols;
    p.rolled = rolled;
    p.tiles_c = (profile_cols + TILE_C - 1) / TILE_C;
    p.orders = orders;
    p.foot = foot;
    const int tiles_r = (window_rows + TILE_R - 1) / TILE_R;
    const size_t smem = static_cast<size_t>(6) * G * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        accumulate_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(n_groups, tiles_r * p.tiles_c);
    accumulate_max_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
