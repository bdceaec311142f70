// Bilateral depth filter for Hopper (sm_90a): the surface colormap's
// smoothing, ops/smooth.py bilateral_filter on CUDA tensors.
//
// Replaces no TPU kernel: the JAX package's filter is plain code
// (topsy_tpu/ops/smooth.py:29-60, a scan over the offsets).  It was added
// because the plain PyTorch version, 41 row offsets each building a
// (41, H, W) unfold and reducing it, took ~57 ms of device time and ~700
// launches a 1024^2 surface frame on an H100 (PERF.md section 5).
//
// What it computes: one channel of an (H, W, C) float32 image becomes
//
//   out = sum(w * s) / sum(w),  w = ws(dy, dx) * exp(-(s - c)^2 * inv_2rs),
//   ws(dy, dx) = exp(-(dy^2 + dx^2) * inv_2ss)
//
// over the (2 half + 1)^2 samples s at (y + dy, x + dx), indices clamped to
// the image (replicate padding, no padded copy), c the centre sample; the
// other channels are copied.  Each tap is the plain version's separate
// float32 operations in its order (d = s - c, d * d, negate, * inv_2rs,
// accurate expf, * ws; built with --fmad=false, so nothing contracts), and
// each neighbourhood row is summed over dx before its partial joins the
// totals, as the plain loop does: only the order of the sums differs.
//
// What bounds it on the H100: one expf per tap.  At 1024^2 and kernel size
// 41 that is 1.76e9 taps a frame, ~0.42 ms on the special-function units
// (132 SMs x 16 a clock) and ~0.53 ms on the float32 pipe at ~10
// instructions a tap; the bytes (the channel read once, the image written
// once) are ~8 MiB each way, nothing beside it.  The compiled loop issues
// ~19 instructions a tap (8 of them the accurate expf, 2 shared-memory
// loads), so the issue rate sets its time: ~1.0 ms at that size.
//
// Design: every tap is evaluated, so the kernel keeps the issue slots on
// the taps.  A block of 32 x BLOCK_Y threads owns a 32 x (BLOCK_Y * ROWS)
// output tile; it stages the tile's channel plus an apron of half pixels,
// clamped, and the (2 half + 1)^2 spatial weights (computed once a block)
// in shared memory.  A thread owns ROWS outputs of one column: each staged
// sample it loads serves every one of them whose neighbourhood holds it,
// and the spatial weight of a tap is a warp-wide broadcast.  Threads along
// x read consecutive words.  The shared memory follows the radius (raised
// past 48 KB where needed); a radius whose tile and weights do not fit the
// block's shared memory (kernel sizes above 157 on an H100, beyond the
// surface's cap of 101 taps) is refused before any launch.  The tile was
// chosen on the card among 1-8 rows a thread and 64-512 threads a block:
// all came within 10% at kernel size 41; at the cap, 256 threads a block
// keep two blocks on an SM where 128 left too few warps.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int ROWS = 2;          // outputs a thread, along y
constexpr int BLOCK_Y = 8;
constexpr int TILE_H = ROWS * BLOCK_Y;
constexpr int THREADS = TILE_W * BLOCK_Y;
// topsy_bilateral_filter's answer for a radius too large to stage: not a
// cudaError_t, which are all >= 0
constexpr int TOPSY_BILATERAL_TOO_LARGE = -1;

struct Image {
    const float* in;
    float* out;
    int H, W, C, channel;
    long long in_y, in_x, in_c, out_y, out_x, out_c;   // strides, elements
};

__device__ __forceinline__ int clampi(int v, int hi) {
    return min(max(v, 0), hi);
}

__device__ __forceinline__ float spatial_weight(int dy, int dx,
                                                float inv_2ss) {
    return expf(-static_cast<float>(dy * dy + dx * dx) * inv_2ss);
}

// Samples and spatial weights staged in shared memory.  Row t and column
// dx of a thread's window are staged row (first_row + t), column (tx + dx).
struct Staged {
    const float* samp;   // the thread's window's first sample
    int pitch;           // a staged row's length
    const float* tab;    // (K, K) spatial weights
    int K;
    __device__ float sample(int t, int dx) const {
        return samp[t * pitch + dx];
    }
    __device__ float spatial(int r, int dx) const { return tab[r * K + dx]; }
};

// Row t of the thread's window (K + ROWS - 1 rows): output j meets it as
// its neighbourhood row t - j.  Each output's taps are summed over dx, then
// the row's partial joins its totals.  FULL: the row lies in every output's
// neighbourhood (the middle rows), so nothing is tested.
template <bool FULL>
__device__ __forceinline__ void window_row(const Staged& src, int t, int K,
                                           const float (&c)[ROWS],
                                           float inv_2rs,
                                           float (&wsum)[ROWS],
                                           float (&vsum)[ROWS]) {
    float rw[ROWS], rv[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        rw[j] = 0.0f;
        rv[j] = 0.0f;
    }
    for (int dx = 0; dx < K; ++dx) {
        const float s = src.sample(t, dx);
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            if (FULL || static_cast<unsigned>(t - j) < static_cast<unsigned>(K)) {
                const float d = s - c[j];
                const float w = src.spatial(t - j, dx) * expf(-(d * d) * inv_2rs);
                rw[j] += w;
                rv[j] += s * w;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        if (FULL || static_cast<unsigned>(t - j) < static_cast<unsigned>(K)) {
            wsum[j] += rw[j];
            vsum[j] += rv[j];
        }
    }
}

// The ROWS outputs of a thread's column, from its window of K + ROWS - 1
// rows: rows [0, ROWS - 1) and [K, K + ROWS - 1) miss some outputs'
// neighbourhoods, rows [ROWS - 1, K) meet all of them.
__device__ __forceinline__ void filter_column(const Staged& src, int K,
                                              int half, float inv_2rs,
                                              float (&out)[ROWS]) {
    float c[ROWS], wsum[ROWS], vsum[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        c[j] = src.sample(j + half, half);
        wsum[j] = 0.0f;
        vsum[j] = 0.0f;
    }
    int t = 0;
    for (; t < ROWS - 1; ++t)
        window_row<false>(src, t, K, c, inv_2rs, wsum, vsum);
    for (; t < K; ++t)
        window_row<true>(src, t, K, c, inv_2rs, wsum, vsum);
    for (; t < K + ROWS - 1; ++t)
        window_row<false>(src, t, K, c, inv_2rs, wsum, vsum);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) out[j] = vsum[j] / wsum[j];
}

__global__ void __launch_bounds__(THREADS)
bilateral_kernel(Image im, int half, float inv_2ss, float inv_2rs) {
    extern __shared__ float smem[];
    const int K = 2 * half + 1;
    const int pitch = TILE_W + 2 * half;
    const int rows = TILE_H + 2 * half;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TILE_W + tx;
    const int x = blockIdx.x * TILE_W + tx;
    const int y0 = blockIdx.y * TILE_H + ty * ROWS;   // first output row
    const int H1 = im.H - 1, W1 = im.W - 1;
    const float* chan = im.in + im.channel * im.in_c;

    float* tab = smem;
    float* samp = smem + K * K;
    for (int i = tid; i < K * K; i += THREADS)
        tab[i] = spatial_weight(i / K - half, i % K - half, inv_2ss);
    const int gy = blockIdx.y * TILE_H - half;
    const int gx = blockIdx.x * TILE_W - half;
    for (int i = tid; i < rows * pitch; i += THREADS) {
        const int r = i / pitch;
        const int q = i - r * pitch;
        samp[i] = chan[clampi(gy + r, H1) * im.in_y
                       + clampi(gx + q, W1) * im.in_x];
    }
    __syncthreads();
    float filtered[ROWS];
    filter_column(Staged{samp + ty * ROWS * pitch + tx, pitch, tab, K}, K,
                  half, inv_2rs, filtered);

    if (x > W1) return;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        const int y = y0 + j;
        if (y > H1) break;
        const float* src = im.in + y * im.in_y + x * im.in_x;
        float* dst = im.out + y * im.out_y + x * im.out_x;
        for (int cc = 0; cc < im.C; ++cc)
            dst[cc * im.out_c] = cc == im.channel ? filtered[j]
                                                  : src[cc * im.in_c];
    }
}

}  // namespace

// Filter channel ``channel`` of the (H, W, C) float32 image ``in`` into
// ``out`` (every channel written), on ``stream``; strides in elements.
// Returns the launch's cudaError_t (0 = ok), or TOPSY_BILATERAL_TOO_LARGE,
// launching nothing, where the tile and weights of a radius of ``half``
// do not fit a block's shared memory on the current device.
extern "C" int topsy_bilateral_filter(
        const float* in, float* out, int H, int W, int C, int channel,
        long long in_y, long long in_x, long long in_c, long long out_y,
        long long out_x, long long out_c, int half, float inv_2ss,
        float inv_2rs, void* stream) {
    if (H < 1 || W < 1 || C < 1 || channel < 0 || channel >= C || half < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long K = 2LL * half + 1;
    const long long bytes = static_cast<long long>(sizeof(float))
        * (K * K + (TILE_H + 2LL * half) * (TILE_W + 2LL * half));
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bytes > optin) return TOPSY_BILATERAL_TOO_LARGE;
    if (bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(bilateral_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const Image im{in, out, H, W, C, channel,
                   in_y, in_x, in_c, out_y, out_x, out_c};
    const dim3 block(TILE_W, BLOCK_Y);
    const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
    bilateral_kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(
        im, half, inv_2ss, inv_2rs);
    return static_cast<int>(cudaGetLastError());
}
