// Host-side event wire encoder (OpenMP).
//
// The one host-CPU-bound stage of the production input path is the
// compact H2D encode (train/steps.py compact_event_view): padded float
// event arrays -> uint16 fixed-point coords + uint8 polarity + per-row
// valid count. numpy needs ~6 full passes over the batch (round, mul,
// astype x3, sum); this fuses them into one parallel pass. The heavy
// representation math itself (voxelization etc.) runs ON DEVICE
// (data/representations.py) by design, so no host rasterizer lives here.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -fopenmp event_ops.cpp

#include <cstdint>

extern "C" {

// x, y, p: (B, L) float32; valid: (B, L) uint8/bool.
// Outputs xq, yq: (B, L) uint16 = round(v * scale); pq: (B, L) uint8;
// n_out: (B,) int32 count of valid entries per row.
void compact_encode(const float* x, const float* y, const float* p,
                    const uint8_t* valid, int64_t B, int64_t L,
                    float scale, uint16_t* xq, uint16_t* yq, uint8_t* pq,
                    int32_t* n_out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t b = 0; b < B; ++b) {
    const int64_t off = b * L;
    int32_t n = 0;
    for (int64_t i = off; i < off + L; ++i) {
      xq[i] = (uint16_t)(x[i] * scale + 0.5f);
      yq[i] = (uint16_t)(y[i] * scale + 0.5f);
      pq[i] = (uint8_t)p[i];
      n += (int32_t)(valid[i] != 0);
    }
    n_out[b] = n;
  }
}

}  // extern "C"
