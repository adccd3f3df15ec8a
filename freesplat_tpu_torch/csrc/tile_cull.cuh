// Per-warp culling of a tile's instances, shared by csrc/rasterize_fwd.cu
// and csrc/rasterize_bwd.cu.  The plain version is
// ops/rasterizer.py::warp_cull_mask_plain; keep the two in step.
//
// Pixel map.  Thread i of a tile's 256 is lane l = i % 32 of warp
// w = i / 32 and owns pixel p = row * 16 + col with col = 8 (w % 2) + l % 8
// and row = 4 (w / 2) + l / 8: each warp covers an 8x4 block of the tile
// (a ~14-pixel footprint touches fewer of these than of 16x2 strips).
//
// Mask.  Bit w of an instance's mask says warp w's pixels may pass the
// compositors' cut (power <= 0 and alpha >= 1/255).  A pixel can pass only
// inside the ellipse q = a dx^2 + 2 b dx dy + c dy^2 <= thr,
// thr = 2 ln(op / ALPHA_MIN), so the test is that ellipse's bounding box
// (half-extents sqrt(thr c / det), sqrt(thr a / det)) against the warp's
// pixel rectangle grown by one pixel.  It must never drop a pair the exact
// per-pair test would keep, so it is conservative:
// - thr is raised by 1e-4 (expf, the alpha product and ALPHA_MIN's own
//   rounding move the cut's q by < 1e-6) and divided by 1 - 32 u K, where
//   u = 2^-24 and K = (a + c)^2 / det >= (a dx^2 + c dy^2) / q: the float32
//   evaluation of power errs by < 3 u (a dx^2 + c dy^2) on the squares and
//   their sum, < 2 u |2 b dx dy| <= 2 u (a dx^2 + c dy^2) on the cross term
//   and u |power| on the last subtraction, so q_true (1 - 5 u K) <=
//   q_kernel (1 + 2 u);
// - the one-pixel margin covers dx/dy rounding (coordinates < 2^20) and
//   the float32 rounding of the box edges;
// - det is taken in double (the float products are exact there), the rest
//   in float32 with the extents raised by 1e-5 relative;
// - anything the bounds do not cover culls nothing (all 8 bits): a
//   non-finite field, a conic that is not positive definite, K > 2^18,
//   a mean or a half-extent beyond 1e6 px.
// An opacity below ALPHA_MIN can pass nowhere (exp(power) <= 1 where
// power <= 0): the mask is empty.
#pragma once
#include <cuda_runtime.h>

namespace tile_cull {

constexpr int TILE = 16;
constexpr int WARP_COLS = 8;  // pixels of a warp's block: 8 wide, 4 high
constexpr int WARP_ROWS = 4;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float K_MAX = 262144.0f;  // 2^18: 32 u K <= 0.5
constexpr float COORD_MAX = 1e6f;

// Pixel (0..255, row-major in the tile) of thread ``i``.
__device__ __forceinline__ int pixel_of_thread(int i) {
  const int w = i >> 5, l = i & 31;
  return (WARP_ROWS * (w >> 1) + (l >> 3)) * TILE + WARP_COLS * (w & 1) + (l & 7);
}

// 8-bit warp mask of one instance row d (mx, my, conic a, b, c, opacity,
// ...) in the tile whose top-left pixel is (x0, y0).
__device__ __forceinline__ unsigned warp_mask(const float* d, float x0, float y0) {
  const float mx = d[0], my = d[1], a = d[2], b = d[3], c = d[4], op = d[5];
  const bool finite = isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) &&
                      isfinite(c) && isfinite(op);
  if (!finite) return 0xffu;
  if (op < ALPHA_MIN) return 0u;
  const double det_d = (double)a * (double)c - (double)b * (double)b;
  if (!(a > 0.0f && c > 0.0f && det_d > 0.0)) return 0xffu;
  const float det = (float)det_d;
  const float k = (a + c) * (a + c) / det;
  if (!(k <= K_MAX && fabsf(mx) <= COORD_MAX && fabsf(my) <= COORD_MAX)) return 0xffu;
  const float thr = (2.0f * logf(op / ALPHA_MIN) + 1e-4f) / (1.0f - 32.0f * 5.9604645e-8f * k);
  const float ex = sqrtf(thr * c / det) * (1.0f + 1e-5f);
  const float ey = sqrtf(thr * a / det) * (1.0f + 1e-5f);
  if (!(ex <= COORD_MAX && ey <= COORD_MAX)) return 0xffu;
  unsigned cols = 0u, rows = 0u;
#pragma unroll
  for (int i = 0; i < TILE / WARP_COLS; ++i) {
    const float lo = x0 + (float)(WARP_COLS * i) - 1.0f;
    const float hi = lo + (float)(WARP_COLS + 1);
    if (mx - ex <= hi && mx + ex >= lo) cols |= 1u << i;
  }
#pragma unroll
  for (int i = 0; i < TILE / WARP_ROWS; ++i) {
    const float lo = y0 + (float)(WARP_ROWS * i) - 1.0f;
    const float hi = lo + (float)(WARP_ROWS + 1);
    if (my - ey <= hi && my + ey >= lo) rows |= 1u << i;
  }
  unsigned m = 0u;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    if (((cols >> (w & 1)) & 1u) && ((rows >> (w >> 1)) & 1u)) m |= 1u << w;
  }
  return m;
}

}  // namespace tile_cull
