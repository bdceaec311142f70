// Native host-side runtime of topsy_tpu_torch: the cell sort, the interleaved
// LOD order and the (smoothing-bucket, Morton) presort, parallelized with
// OpenMP.  A pinned copy of topsy_tpu/native/_native.cpp without the kNN
// smoothing (snapshot files are not loaded by the port yet).
//
// Exposed with a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Counting sort of particles by cell id: fills ordering such that
// positions[ordering] is cell-contiguous, plus per-cell offsets/lengths.
// Returns 0 on success, nonzero if a position is out of bounds.
// ---------------------------------------------------------------------------
int cell_sort(const float* pos, int64_t n, double box_min, double box_max,
              int nside, int64_t* ordering, int64_t* offsets,
              int64_t* lengths) {
  const int64_t ncell = (int64_t)nside * nside * nside;
  const double cell_size = (box_max - box_min) / nside;

  std::vector<int32_t> cell_of(n);
  std::atomic<int> bad{0};

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int ix = (int)std::floor((pos[3 * i + 0] - box_min) / cell_size);
    int iy = (int)std::floor((pos[3 * i + 1] - box_min) / cell_size);
    int iz = (int)std::floor((pos[3 * i + 2] - box_min) / cell_size);
    if (ix < 0 || iy < 0 || iz < 0 || ix >= nside || iy >= nside ||
        iz >= nside) {
      bad.store(1, std::memory_order_relaxed);
      cell_of[i] = 0;
    } else {
      cell_of[i] = iz + nside * (iy + nside * ix);
    }
  }
  if (bad.load()) return 1;

  std::fill(lengths, lengths + ncell, 0);
  for (int64_t i = 0; i < n; ++i) lengths[cell_of[i]]++;

  int64_t acc = 0;
  for (int64_t c = 0; c < ncell; ++c) {
    offsets[c] = acc;
    acc += lengths[c];
  }

  std::vector<int64_t> cursor(offsets, offsets + ncell);
  for (int64_t i = 0; i < n; ++i) ordering[cursor[cell_of[i]]++] = i;
  return 0;
}

// ---------------------------------------------------------------------------
// Interleaved LOD order: stable sort of per-particle keys
// (i_within_cell + 1 - phi_c) / len_c so any global prefix is the reference's
// per-cell phase-shifted selection (see cells.CellLayout.interleave_order).
// Inputs describe the cell-sorted layout; output is an index array into it.
// ---------------------------------------------------------------------------
void interleave_order(const int64_t* offsets, const int64_t* lengths,
                      const double* phi, int64_t ncell, int64_t n,
                      int64_t* order) {
  std::vector<double> keys(n);
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t c = 0; c < ncell; ++c) {
    const int64_t off = offsets[c], len = lengths[c];
    for (int64_t j = 0; j < len; ++j)
      keys[off + j] = ((double)(j + 1) - phi[c]) / (double)len;
  }
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order, order + n, [&](int64_t a, int64_t b) {
    return keys[a] < keys[b];
  });
}

// ---------------------------------------------------------------------------
// Presort order for sort-free splatting (ops/morton.py): key = 1/8-octave
// smoothing bucket (high bits) | 3x16-bit Morton code, LSD radix sorted.
// Mirrors the numpy implementation exactly (same quantization, same key),
// ~10x faster for the one-time build on large snapshots.  Fills
// buckets_out[i] with the absolute bucket of INPUT particle i, and
// order_out with the sorted permutation.
// ---------------------------------------------------------------------------
static inline uint64_t spread_bits16(uint64_t x) {
  x &= 0xFFFFull;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  x = (x | (x << 1)) & 0x5555555555555555ull;
  return x;
}

void presort_order(const float* pos_smooth /* (n,4) */, int64_t n,
                   double delta_octave, int32_t* buckets_out,
                   int64_t* order_out) {
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i) {
    for (int a = 0; a < 3; ++a) {
      double v = pos_smooth[4 * i + a];
      if (v < lo[a]) lo[a] = v;
      if (v > hi[a]) hi[a] = v;
    }
  }
  double span[3];
  for (int a = 0; a < 3; ++a) span[a] = hi[a] - lo[a] + 1e-300;

  int32_t bmin = INT32_MAX;
#pragma omp parallel for reduction(min : bmin) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double h = pos_smooth[4 * i + 3];
    if (h < 1e-300) h = 1e-300;
    int32_t b = (int32_t)std::floor(std::log2(h) / delta_octave);
    buckets_out[i] = b;
    if (b < bmin) bmin = b;
  }

  std::vector<uint64_t> key(n), key2(n);
  std::vector<uint32_t> idx(n), idx2(n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint64_t m = 0;
    for (int a = 0; a < 3; ++a) {
      uint64_t q = (uint64_t)((pos_smooth[4 * i + a] - lo[a]) / span[a] *
                              65535.0);
      m |= spread_bits16(q) << a;
    }
    key[i] = ((uint64_t)(uint32_t)(buckets_out[i] - bmin) << 48) | m;
    idx[i] = (uint32_t)i;
  }

  // LSD radix, 8 passes of 8 bits (stable)
  std::vector<int64_t> count(256);
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = 8 * pass;
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; ++i) count[(key[i] >> shift) & 0xFF]++;
    int64_t acc = 0;
    for (int b = 0; b < 256; ++b) {
      int64_t c = count[b];
      count[b] = acc;
      acc += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t d = count[(key[i] >> shift) & 0xFF]++;
      key2[d] = key[i];
      idx2[d] = idx[i];
    }
    key.swap(key2);
    idx.swap(idx2);
  }
  for (int64_t i = 0; i < n; ++i) order_out[i] = idx[i];
}

int native_abi_version() { return 2; }

}  // extern "C"
