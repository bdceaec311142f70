// The spill tiers' deposit operands for Hopper (sm_90a): ops/splat_atlas.py
// spill_tiers on CUDA tensors.
//
// Replaces no TPU kernel: the JAX package builds these operands in plain
// code (topsy_tpu/ops/splat_atlas.py spill_pass), as the port's plain
// version spill_tiers_plain does.  It was added because that chain, ~115
// PyTorch calls a feed piece (three stable sorts among them), was over half
// of the device operations an additive EXPORT frame enqueues, and the
// card waited on the host's enqueue (PERF.md sections 5 and 6).
//
// What it computes, from a feed piece's per-slot ay, ax, ih and C
// coefficient rows (zero where a particle did not spill) and its per-group
// spill counts (n_groups groups of G slots):
//   selection  the k_groups groups with the most spills, ties to the lower
//              index, in index order (torch.sort of _topk_desc_stable);
//   tier 2     their slots in groups of G_SPILL: the row anchor from the
//              group's lowest valid ay, the fit to its full-width window,
//              the fitted coefficients, the flags (kind * 4 + FULL_CLASS);
//   tier 3     the first T3 stragglers (valid, not fitting) in gathered
//              order, then non-stragglers: one-particle groups with their
//              anchors, sizes and flags;
//   dropped    (n_spill - valid gathered) + max(n3 - T3, 0).
// Every entry, inactive ones included, equals spill_tiers_plain's bit for
// bit: the float operations are the plain version's, separately rounded
// (__fadd_rn / __fsub_rn / __fdiv_rn; the build passes --fmad=false), the
// float -> int32 casts cvt.rzi (NaN -> 0, saturating) as a CUDA tensor's
// .to(torch.int32), the int32 products wrapping as torch's do.
//
// What bounds it on the H100: neither bytes nor operations.  A frame
// piece reads 128 groups of 512 slots (~1.3 MB at C = 2) and writes as
// much; the work is a few µs of latency-bound passes.  What it saves is
// the host's enqueue: one ctypes call and three launches instead of ~115
// PyTorch calls, with no host synchronisation.
//
// Design, three launches on the caller's stream:
//  - select_kernel, one block: a histogram of the counts (0..G) in shared
//    memory, warp-aggregated atomics; a scan of the bins from the top
//    finds the k-th largest count t and how many of its ties are taken;
//    a scan in index order writes the groups above t and the first ties:
//    each warp takes a contiguous chunk 32 groups at a time, so its reads
//    coalesce, and ranks its lanes by ballots.  It also sums n_spill.
//  - tier2_kernel, a block per tier-2 group: it reads only the gathered
//    slots; validity is sum |c| > 0 on their rows, so no full-plane pass
//    is needed; block reductions (__syncthreads_or / _and, a min) give the
//    anchor and the flags.  Each slot's (valid, straggler) byte is kept.
//  - tier3_kernel, one block: a scan of those bytes (warp chunks and
//    ballots, as above) ranks every straggler and non-straggler and
//    records the slot of each of the first T3 ranks; then the block writes
//    those entries a rank a thread, so that their gathers overlap (written
//    by the thread that ranked them, the entries of the first slots would
//    queue behind one another in a few threads).  Last, the dropped count.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by ops/splat_atlas.py's _SpillScalars (ctypes).
// Offsets are in elements of out_f (float) and out_i (int32):
// out_f: tier 2's (3 + C, spill_cap) at 0, tier 3's (3 + C, T3) at f_t3;
// out_i: tier 2's (3, n_sg) at 0 (w0, zeros, flags), tier 3's (4, T3) at
// i_t3 (w0, c0, ce, flags), the gathered groups (k_groups) at i_gidx, a
// byte a gathered slot (valid | straggler << 1) at i_slots, tier 3's
// gathered slot an entry (slot * 2 + straggler) at i_order.
struct SpillScalars {
    long long n_groups;
    long long f_t3;
    long long i_t3;
    long long i_gidx;
    long long i_slots;
    long long i_order;
    int G, C, g_spill, k_groups, n_sg, t3;
    int window_rows, w0_top, c0_top, band, col_align, ce_span;
    float foot, big_th, row_pad;
};

namespace {

constexpr int MAX_C = 4;
constexpr int MAX_G = 8192;          // the histogram's bins in shared memory
constexpr int SCAN_THREADS = 1024;   // select_kernel and tier3_kernel
constexpr int FLAG_INACTIVE = 0, FLAG_ALL_TINY = 1, FLAG_POLY = 2,
              FLAG_MIXED = 3, FLAG_MASKED = 4, FULL_CLASS = 3;
constexpr unsigned char SLOT_VALID = 1, SLOT_STRAGGLER = 2;

struct SpillArgs {
    SpillScalars s;
    const float *ay, *ax, *ih, *coef;
    const int* counts;
    float* out_f;
    int* out_i;
    long long* out_l;    // (2,): dropped, n_spill
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// floor((v - foot) / band) as int32, times band: torch's int32 product
// wraps, so the product is taken unsigned
__device__ __forceinline__ int band_anchor(float v, const SpillScalars& s) {
    const int r = static_cast<int>(floorf(
        __fdiv_rn(__fsub_rn(v, s.foot), static_cast<float>(s.band))));
    return static_cast<int>(static_cast<unsigned>(r)
                            * static_cast<unsigned>(s.band));
}

__device__ __forceinline__ int floordiv(int x, int d) {
    int q = x / d;
    return (x % d != 0 && ((x < 0) != (d < 0))) ? q - 1 : q;
}

// the source slot of gathered slot q
__device__ __forceinline__ long long source_slot(const SpillArgs& a,
                                                 const int* gidx,
                                                 long long q) {
    const long long g = q / a.s.G;
    return static_cast<long long>(gidx[g]) * a.s.G + (q - g * a.s.G);
}

// the slot's coefficients and whether it spilled (their |sum| > 0; NaN
// gives false, as in the plain version, in any order of the sum)
__device__ __forceinline__ bool load_coef(const SpillArgs& a, long long src,
                                          float (&c)[MAX_C]) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k) {
        c[k] = k < a.s.C ? a.coef[k * a.s.n_groups * a.s.G + src] : 0.0f;
        sum = __fadd_rn(sum, fabsf(c[k]));
    }
    return sum > 0.0f;
}

// exclusive prefix of v over the block's threads in order, and the total;
// blockDim.x a multiple of 32; ``warp`` holds 32 entries
template <typename T>
__device__ T block_scan(T v, T* warp, T& total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp[w] = x;
    __syncthreads();
    if (w == 0) {
        T t = lane < nw ? warp[lane] : T(0);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const T y = __shfl_up_sync(0xffffffffu, t, o);
            if (lane >= o) t += y;
        }
        if (lane < nw) warp[lane] = t;
    }
    __syncthreads();
    const T before = w ? warp[w - 1] : T(0);
    total = warp[nw - 1];
    __syncthreads();
    return before + x - v;
}

// [i0, i1) of this warp's chunk of n items: contiguous, a multiple of 32
// long, so that its lanes read 32 neighbours at a time
__device__ __forceinline__ void warp_chunk(long long n, int& i0, int& i1) {
    const long long warps = blockDim.x >> 5;
    const long long len = (n + warps * 32 - 1) / (warps * 32) * 32;
    const long long w = threadIdx.x >> 5;
    i0 = static_cast<int>(min(w * len, n));
    i1 = static_cast<int>(min(w * len + len, n));
}

// exclusive prefix over the block's warps of a warp-uniform value, in
// every lane of the warp, and the total
__device__ __forceinline__ int warp_scan(int v, int* warp, int& total) {
    const int before = block_scan<int>((threadIdx.x & 31) == 0 ? v : 0,
                                       warp, total);
    return __shfl_sync(0xffffffffu, before, 0);
}

__global__ void __launch_bounds__(SCAN_THREADS) select_kernel(SpillArgs a) {
    extern __shared__ int hist[];          // G + 1 bins
    __shared__ long long warp_l[32];
    __shared__ int warp_i[32];
    __shared__ int sh_t, sh_need;
    const SpillScalars& s = a.s;
    const int G = s.G, n = static_cast<int>(s.n_groups), k = s.k_groups;
    const int tid = threadIdx.x, lane = tid & 31;
    for (int b = tid; b <= G; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    long long mine = 0;
    for (int base = 0; base < n; base += blockDim.x) {
        const int i = base + tid;
        const int c = i < n ? a.counts[i] : 0;
        mine += c;
        const int bin = i < n ? clampi(c, 0, G) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    long long n_spill;
    block_scan<long long>(mine, warp_l, n_spill);
    if (tid == 0) a.out_l[1] = n_spill;

    // the k-th largest count t, and how many of its ties the selection
    // takes: bins from the top, a chunk of bins a thread
    const int nb = (G + 1 + blockDim.x - 1) / blockDim.x;
    const int r0 = min(tid * nb, G + 1), r1 = min(r0 + nb, G + 1);
    int here = 0;
    for (int r = r0; r < r1; ++r) here += hist[G - r];
    int all;
    const int above = block_scan<int>(here, warp_i, all);
    if (above < k && above + here >= k) {
        int cum = above;
        for (int r = r0; r < r1; ++r) {
            const int h = hist[G - r];
            if (cum + h >= k) {
                sh_t = G - r;
                sh_need = k - cum;
                break;
            }
            cum += h;
        }
    }
    __syncthreads();
    const int t = sh_t, need = sh_need;

    // index order, a chunk of groups a warp read 32 at a time: every group
    // above t, and the first ``need`` ties
    int i0, i1;
    warp_chunk(n, i0, i1);
    int ties = 0, over = 0;
    for (int base = i0; base < i1; base += 32) {
        const int i = base + lane;
        const int c = i < i1 ? clampi(a.counts[i], 0, G) : -1;
        ties += __popc(__ballot_sync(0xffffffffu, c == t));
        over += __popc(__ballot_sync(0xffffffffu, c > t));
    }
    int tie = warp_scan(ties, warp_i, all);
    const int take = over + clampi(need - tie, 0, ties);
    int pos = warp_scan(take, warp_i, all);
    int* gidx = a.out_i + s.i_gidx;
    const unsigned below = (1u << lane) - 1u;
    for (int base = i0; base < i1; base += 32) {
        const int i = base + lane;
        const int c = i < i1 ? clampi(a.counts[i], 0, G) : -1;
        const unsigned tied = __ballot_sync(0xffffffffu, c == t);
        const bool keep = c > t
                          || (c == t && tie + __popc(tied & below) < need);
        const unsigned kept = __ballot_sync(0xffffffffu, keep);
        if (keep) gidx[pos + __popc(kept & below)] = i;
        tie += __popc(tied);
        pos += __popc(kept);
    }
}

__global__ void tier2_kernel(SpillArgs a) {
    __shared__ float warp_min[32];
    const SpillScalars& s = a.s;
    const int j = blockIdx.x, gs = s.g_spill, C = s.C;
    const int tid = threadIdx.x, lane = tid & 31;
    const int* gidx = a.out_i + s.i_gidx;
    const long long cap = static_cast<long long>(s.n_sg) * gs;

    // the lowest valid ay (NaN propagates, as amin), ih's tests
    float lo = INFINITY;
    bool nan_ay = false, all_tiny = true, any_tiny = false, nan_ih = false,
         any_big = false;
    for (int l = tid; l < gs; l += blockDim.x) {
        const long long src = source_slot(a, gidx,
                                          static_cast<long long>(j) * gs + l);
        float c[MAX_C];
        const float ay = a.ay[src], ih = a.ih[src];
        if (load_coef(a, src, c)) {
            if (isnan(ay)) nan_ay = true;
            else lo = fminf(lo, ay);
        }
        all_tiny &= ih < 0.0f;
        any_tiny |= ih < 0.0f;
        nan_ih |= isnan(ih);
        any_big |= ih > 0.0f && ih < s.big_th;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    if (lane == 0) warp_min[tid >> 5] = lo;
    nan_ay = __syncthreads_or(nan_ay);    // also orders warp_min
    float m = warp_min[0];
    for (int w = 1; w < (blockDim.x >> 5); ++w) m = fminf(m, warp_min[w]);
    const float ay_min = (nan_ay || !isfinite(m)) ? s.row_pad : m;
    const int w0 = clampi(band_anchor(ay_min, s), 0, s.w0_top);
    const float bottom = __fadd_rn(static_cast<float>(w0),
                                   static_cast<float>(s.window_rows));

    bool any_fit = false;
    unsigned char* slots = reinterpret_cast<unsigned char*>(a.out_i
                                                            + s.i_slots);
    for (int l = tid; l < gs; l += blockDim.x) {
        const long long q = static_cast<long long>(j) * gs + l;
        const long long src = source_slot(a, gidx, q);
        float c[MAX_C];
        const bool valid = load_coef(a, src, c);
        const float ay = a.ay[src];
        const bool fits = valid && __fadd_rn(ay, s.foot) < bottom;
        a.out_f[q] = ay;
        a.out_f[cap + q] = a.ax[src];
        a.out_f[2 * cap + q] = a.ih[src];
        for (int k = 0; k < C; ++k)
            a.out_f[(3 + k) * cap + q] = fits ? c[k] : 0.0f;
        slots[q] = (valid ? SLOT_VALID : 0)
                   | (valid && !fits ? SLOT_STRAGGLER : 0);
        any_fit |= fits;
    }
    // group_flags: active where a fitted coefficient is nonzero, which is
    // where a slot fits (a fitting slot is valid: its |sum| > 0)
    const bool active = __syncthreads_or(any_fit);
    all_tiny = __syncthreads_and(all_tiny);      // amax < 0: false on NaN
    any_tiny = __syncthreads_or(any_tiny);
    nan_ih = __syncthreads_or(nan_ih);           // amin < 0: false on NaN
    any_big = __syncthreads_or(any_big);
    if (tid == 0) {
        const int kind = !active ? FLAG_INACTIVE
                         : all_tiny ? FLAG_ALL_TINY
                         : any_big ? FLAG_MASKED
                         : (any_tiny && !nan_ih) ? FLAG_MIXED : FLAG_POLY;
        a.out_i[j] = w0;
        a.out_i[s.n_sg + j] = 0;
        a.out_i[2 * s.n_sg + j] = kind * 4 + FULL_CLASS;
    }
}

// tier 3 entry ``pos`` from gathered slot q
__device__ void tier3_entry(const SpillArgs& a, long long pos, long long q,
                            bool straggler) {
    const SpillScalars& s = a.s;
    const long long t3 = s.t3;
    const long long src = source_slot(a, a.out_i + s.i_gidx, q);
    float c[MAX_C];
    load_coef(a, src, c);
    const float ay = a.ay[src], ax = a.ax[src], ih = a.ih[src];
    float* f = a.out_f + s.f_t3;
    f[pos] = ay;
    f[t3 + pos] = ax;
    f[2 * t3 + pos] = ih;
    for (int k = 0; k < s.C; ++k)
        f[(3 + k) * t3 + pos] = straggler ? c[k] : 0.0f;
    const int w0_raw = band_anchor(ay, s);
    const int w0 = clampi(w0_raw, 0, s.w0_top);
    const int ce_raw = static_cast<int>(floorf(__fsub_rn(ax, s.foot)));
    const int c0 = clampi(floordiv(ce_raw, s.col_align) * s.col_align, 0,
                          s.c0_top);
    const int ce = min(max(ce_raw, c0), c0 + s.ce_span);
    // an anchor clipped at the atlas bottom takes the full class; a
    // one-slot group is active where it is a straggler, and never mixed
    const int kind = !straggler ? FLAG_INACTIVE
                     : ih < 0.0f ? FLAG_ALL_TINY
                     : (ih > 0.0f && ih < s.big_th) ? FLAG_MASKED : FLAG_POLY;
    const int size = (kind == FLAG_ALL_TINY || kind == FLAG_POLY)
                     ? (w0_raw != w0 ? FULL_CLASS : 1) : FULL_CLASS;
    int* o = a.out_i + s.i_t3;
    o[pos] = w0;
    o[t3 + pos] = c0;
    o[2 * t3 + pos] = ce;
    o[3 * t3 + pos] = kind * 4 + size;
}

__global__ void __launch_bounds__(SCAN_THREADS) tier3_kernel(SpillArgs a) {
    __shared__ int warp_i[32];
    const SpillScalars& s = a.s;
    const int lane = threadIdx.x & 31;
    const unsigned char* slots = reinterpret_cast<const unsigned char*>(
        a.out_i + s.i_slots);
    int* order = a.out_i + s.i_order;
    int q0, q1;
    warp_chunk(static_cast<long long>(s.n_sg) * s.g_spill, q0, q1);
    int valid = 0, strag = 0;
    for (int base = q0; base < q1; base += 32) {
        const int q = base + lane;
        const unsigned f = q < q1 ? slots[q] : 0u;
        valid += __popc(__ballot_sync(0xffffffffu, f & SLOT_VALID));
        strag += __popc(__ballot_sync(0xffffffffu, f & SLOT_STRAGGLER));
    }
    int n_valid, n3;
    warp_scan(valid, warp_i, n_valid);
    int before = warp_scan(strag, warp_i, n3);
    // stragglers take ranks [0, n3) in gathered order, the others follow:
    // each of the first T3 ranks records its slot ...
    const unsigned below = (1u << lane) - 1u;
    for (int base = q0; base < q1; base += 32) {
        const int q = base + lane;
        const bool st = q < q1 && (slots[q] & SLOT_STRAGGLER);
        const unsigned m = __ballot_sync(0xffffffffu, st);
        const int rank = before + __popc(m & below);
        const long long pos = st ? rank
                                 : n3 + static_cast<long long>(q - rank);
        if (q < q1 && pos < s.t3) order[pos] = q * 2 + st;
        before += __popc(m);
    }
    __syncthreads();
    // ... then the block writes the entries, a rank a thread
    for (int pos = threadIdx.x; pos < s.t3; pos += blockDim.x)
        tier3_entry(a, pos, order[pos] >> 1, order[pos] & 1);
    if (threadIdx.x == 0)
        a.out_l[0] = a.out_l[1] - n_valid + max(n3 - s.t3, 0);
}

}  // namespace

// Launch the three kernels on ``stream``: ay, ax, ih (n_groups * G) f32,
// coef (C, n_groups * G) f32, counts (n_groups) i32; out_f,
// out_i and out_l (2) laid out as the scalars say.  Returns the first
// launch's cudaError_t that is not 0, else 0.
extern "C" int topsy_spill_tiers(const SpillScalars* s, const float* ay,
                                 const float* ax, const float* ih,
                                 const float* coef, const int* counts,
                                 float* out_f, int* out_i, long long* out_l,
                                 void* stream) {
    if (s->G < 1 || s->G > MAX_G || s->C < 1 || s->C > MAX_C
        || s->g_spill < 1 || s->k_groups < 1 || s->k_groups > s->n_groups
        || s->n_sg < 1 || s->t3 < 1
        || static_cast<long long>(s->n_sg) * s->g_spill
               != static_cast<long long>(s->k_groups) * s->G)
        return static_cast<int>(cudaErrorInvalidValue);
    SpillArgs a;
    a.s = *s;
    a.ay = ay; a.ax = ax; a.ih = ih; a.coef = coef; a.counts = counts;
    a.out_f = out_f; a.out_i = out_i; a.out_l = out_l;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    select_kernel<<<1, SCAN_THREADS, (s->G + 1) * sizeof(int), st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int warps = (s->g_spill + 31) / 32;
    const int threads = warps < 8 ? warps * 32 : 256;
    tier2_kernel<<<s->n_sg, threads, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tier3_kernel<<<1, SCAN_THREADS, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}
