// Native host-side runtime of topsy_tpu_torch: the cell sort, the interleaved
// LOD order, the exact kNN smoothing lengths and the (smoothing-bucket,
// Morton) presort, parallelized with OpenMP.  A pinned copy of
// topsy_tpu/native/_native.cpp.
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
// Exact k-nearest-neighbour smoothing lengths via a uniform grid with
// expanding-shell search.  h = 0.5 * distance to the nn-th neighbour,
// pynbody's convention (nn neighbours within the 2h kernel support).
// ---------------------------------------------------------------------------
void knn_smooth(const float* pos, int64_t n, int nn, float* h_out) {
  if (n == 0) return;
  float lo[3] = {pos[0], pos[1], pos[2]};
  float hi[3] = {pos[0], pos[1], pos[2]};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pos[3 * i + d]);
      hi[d] = std::max(hi[d], pos[3 * i + d]);
    }
  double span = 1e-30;
  for (int d = 0; d < 3; ++d) span = std::max(span, (double)hi[d] - lo[d]);
  span *= 1.0 + 1e-6;

  // grid sized for ~2-8 particles per cell
  int nside = (int)std::floor(std::cbrt((double)n / 4.0));
  nside = std::max(4, std::min(nside, 512));
  const double cell = span / nside;
  const int64_t ncell = (int64_t)nside * nside * nside;

  std::vector<int64_t> offsets(ncell + 1, 0), lengths(ncell, 0), order(n);
  std::vector<int32_t> cell_of(n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int c[3];
    for (int d = 0; d < 3; ++d) {
      int v = (int)std::floor((pos[3 * i + d] - lo[d]) / cell);
      c[d] = std::max(0, std::min(v, nside - 1));
    }
    cell_of[i] = c[2] + nside * (c[1] + nside * c[0]);
  }
  for (int64_t i = 0; i < n; ++i) lengths[cell_of[i]]++;
  for (int64_t c = 0; c < ncell; ++c) offsets[c + 1] = offsets[c] + lengths[c];
  {
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[cell_of[i]]++] = i;
  }

#pragma omp parallel
  {
    std::vector<float> cand;
    cand.reserve(1024);
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
      int ci[3];
      ci[0] = std::max(0, std::min((int)((px - lo[0]) / cell), nside - 1));
      ci[1] = std::max(0, std::min((int)((py - lo[1]) / cell), nside - 1));
      ci[2] = std::max(0, std::min((int)((pz - lo[2]) / cell), nside - 1));

      cand.clear();
      float knn_d2 = -1.0f;  // current nn-th smallest squared distance
      for (int ring = 0;; ++ring) {
        if (knn_d2 >= 0.0f && ring > 0) {
          // all cells within (ring-1) are fully scanned: stop once the
          // nn-th distance is inside that guaranteed-covered radius
          double safe = (double)(ring - 1) * cell;
          if ((double)knn_d2 <= safe * safe) break;
        }
        bool any_cell = false;
        for (int dx = -ring; dx <= ring; ++dx) {
          int x = ci[0] + dx;
          if (x < 0 || x >= nside) continue;
          for (int dy = -ring; dy <= ring; ++dy) {
            int y = ci[1] + dy;
            if (y < 0 || y >= nside) continue;
            const bool face = (std::abs(dx) == ring || std::abs(dy) == ring);
            for (int dz = -ring; dz <= ring;
                 dz += (face || ring == 0) ? 1 : 2 * ring) {
              int z = ci[2] + dz;
              if (z < 0 || z >= nside) continue;
              any_cell = true;
              int64_t cc = z + (int64_t)nside * (y + (int64_t)nside * x);
              for (int64_t jj = offsets[cc]; jj < offsets[cc + 1]; ++jj) {
                int64_t j = order[jj];
                if (j == i) continue;
                float ddx = pos[3 * j] - px;
                float ddy = pos[3 * j + 1] - py;
                float ddz = pos[3 * j + 2] - pz;
                float v = ddx * ddx + ddy * ddy + ddz * ddz;
                if (knn_d2 < 0.0f || v < knn_d2) cand.push_back(v);
              }
            }
          }
        }
        if ((int64_t)cand.size() >= nn) {
          std::nth_element(cand.begin(), cand.begin() + (nn - 1), cand.end());
          knn_d2 = cand[nn - 1];
          cand.resize(nn);  // keep only survivors for the next rounds
        }
        if (!any_cell && ring > 2 * nside) break;  // degenerate safety
      }
      h_out[i] = 0.5f * std::sqrt(knn_d2 < 0 ? 0.0f : knn_d2);
    }
  }
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
