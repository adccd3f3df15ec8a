// Tile compositing forward of the Gaussian rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel freesplat_tpu/ops/rasterizer.py::_forward_kernel
// (Pallas).  Same outputs, rebuilt for the GPU rather than carried over:
// the TPU kernel's log-space cumsum on the MXU, 128-lane chunks and
// double-buffered DMA are TPU means and are gone.
//
// Design.  One thread block per 16x16 pixel tile, one thread per pixel
// (256 threads); each warp owns an 8x4 pixel block (tile_cull.cuh).  The
// block walks its tile's instances, already sorted front to back by depth,
// in batches of BATCH: each thread copies one instance into shared memory
// and computes its 8-bit warp mask (which warps' pixels it can reach).  Each
// warp then visits only the instances whose bit it holds (a ballot over 32
// at a time), in order, G at a time: first the part of each pair that does
// not depend on the pixel's state (power, alpha, the cut, log1p(-alpha)),
// then the carried part (log T, its exp, the termination test, the four
// accumulations).  A warp whose pixels have all terminated stops visiting;
// the block stops once every pixel has terminated (__syncthreads_count).
// The cull skips only pairs the cut would reject, and every value comes
// from the same expression in the same order as before, so the outputs
// are bit-equal to the plain version (ops/rasterizer.py::
// composite_tiles_plain) with or without it.
//
// Semantics, per pixel and instance, as the TPU kernel and the CUDA
// rasterizer spec:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, with integer pixel
//           coordinates px = tx*16 + col, py = ty*16 + row (no +0.5),
//           where tile t sits at column tx = col_offset + t % tiles_x
//           of the image: a slab of tiles_x columns starting at
//           col_offset (0 for a whole image), as the TPU kernel's
//           tw_ref = [tiles_x_local, col_off];
//   alpha = min(0.99, opacity exp(power)), skipped when power > 0 or
//           alpha < 1/255;
//   a pixel terminates, sticky, at the first instance that would take
//           its transmittance below 1e-4; that instance is not blended;
//   color/depth += alpha T rgb/depth;  log T += log1p(-alpha).
// The per-tile instance count is capped at 16384 (MAX_CHUNKS * CHUNK of
// the TPU kernel); the host reports what the cap drops.
//
// Output per pixel: r, g, b, depth (unnormalized), log T; and the
// backward's residual ``walk``: one past the index of the last instance
// the pixel blended (0 if none).  The backward walks each pixel's
// instances from walk - 1 down to 0 and recovers T before each one from
// the final log T, so it never re-walks the forward.
//
// What bounds it on the H100: not bytes (40 B per instance read once per
// tile, 24 B per pixel written) but the instructions issued per
// (warp, instance) step (power, expf, the cut, log1pf and the blend for
// 32 lanes at once) and each pixel's serial chain (log T -> expf -> the
// termination test -> the next instance).  The cull removes the steps
// whose pixels the instance cannot reach; grouping G instances lets the
// independent expf and log1pf of a group overlap, leaving one add, one
// expf and a compare on the carried chain per blended pair.  PERF.md has
// the counts: the busiest warp's chain is not what bounds it.
#include <cuda_runtime.h>

#include "tile_cull.cuh"

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, one per pixel
constexpr int NF = 10;            // mx my conic_a conic_b conic_c opacity r g b depth
constexpr int BATCH = PIX;        // instances staged per round, one per thread
constexpr int G = 4;              // instances per group of the carried chain
constexpr int MAX_INST = 16384;   // per-tile cap
constexpr int OUT_CH = 5;         // r g b depth logT
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

// Six blocks an SM (at most 40 registers a thread): the 768 tiles of a
// 384x512 view then fit in one wave (132 SMs x 6 = 792 slots), where the
// compiler's own choice (48 registers left 5 blocks an SM and a second, partial
// wave).
__global__ void __launch_bounds__(PIX, 6)
composite_fwd(const float* __restrict__ inst, const int* __restrict__ tile_start,
              const int* __restrict__ tile_count, int tiles_x, int col_offset,
              float* __restrict__ out, int* __restrict__ walk) {
  __shared__ float s_inst[BATCH * NF];
  __shared__ unsigned char s_mask[BATCH];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int p = tile_cull::pixel_of_thread(i);
  const long long start = tile_start[t];
  const int cnt = min(tile_count[t], MAX_INST);
  const float x0 = (float)((col_offset + t % tiles_x) * TILE);
  const float y0 = (float)((t / tiles_x) * TILE);
  const float px = x0 + (float)(p % TILE);
  const float py = y0 + (float)(p / TILE);

  float log_t = 0.0f;  // log transmittance over blended instances
  float trans = 1.0f;  // expf(log_t)
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int walked = 0;  // one past the last blended instance
  bool done = false;

  for (int base = 0; base < cnt; base += BATCH) {
    // Also the barrier that keeps the previous batch alive until read.
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(BATCH, cnt - base);
    if (i < nb) {
      // Rows are 40 B apart, so 8-byte aligned: five float2 loads.
      const float2* src = reinterpret_cast<const float2*>(inst + (start + base + i) * NF);
      float row[NF];
#pragma unroll
      for (int k = 0; k < NF / 2; ++k) {
        const float2 v = src[k];
        row[2 * k] = v.x;
        row[2 * k + 1] = v.y;
      }
#pragma unroll
      for (int k = 0; k < NF; ++k) s_inst[i * NF + k] = row[k];
      s_mask[i] = (unsigned char)tile_cull::warp_mask(row, x0, y0);
    }
    __syncthreads();
    if (__all_sync(FULL, done)) continue;

    for (int c0 = 0; c0 < nb; c0 += 32) {
      const int jl = c0 + lane;
      unsigned bits = __ballot_sync(FULL, jl < nb && ((s_mask[min(jl, nb - 1)] >> warp) & 1u));
      while (bits) {
        int js[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          js[g] = bits ? c0 + __ffs(bits) - 1 : -1;
          bits &= bits - 1u;
        }
        // The pixel-state-free part of each pair.
        float al[G], lm[G];
        bool pass[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float* d = s_inst + max(js[g], 0) * NF;
          const float dx = px - d[0];
          const float dy = py - d[1];
          const float power = -0.5f * (d[2] * dx * dx + d[4] * dy * dy) - d[3] * dx * dy;
          const float alpha = fminf(ALPHA_MAX, d[5] * expf(power));
          pass[g] = js[g] >= 0 && !(power > 0.0f || alpha < ALPHA_MIN);
          al[g] = alpha;
          lm[g] = pass[g] ? log1pf(-alpha) : 0.0f;
        }
        // The carried part, in order.
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (done || !pass[g]) continue;
          const float log_t_next = log_t + lm[g];
          const float trans_next = expf(log_t_next);
          if (trans_next < T_EPS) {
            done = true;
            continue;
          }
          const float* d = s_inst + js[g] * NF;
          const float w = al[g] * trans;
          acc_r = acc_r + w * d[6];
          acc_g = acc_g + w * d[7];
          acc_b = acc_b + w * d[8];
          acc_d = acc_d + w * d[9];
          log_t = log_t_next;
          trans = trans_next;
          walked = base + js[g] + 1;
        }
        if (__all_sync(FULL, done)) break;
      }
      if (__all_sync(FULL, done)) break;
    }
  }

  float* o = out + ((long long)t * PIX + p) * OUT_CH;
  o[0] = acc_r;
  o[1] = acc_g;
  o[2] = acc_b;
  o[3] = acc_d;
  o[4] = log_t;
  walk[(long long)t * PIX + p] = walked;
}

}  // namespace

// inst: (k, 10) f32; tile_start, tile_count: (num_tiles,) i32, tiles
// row-major over (num_tiles / tiles_x, tiles_x), the first column at
// image tile column col_offset; out: (num_tiles, 256, 5) f32; walk:
// (num_tiles, 256) i32.  Launches on ``stream``; returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int freesplat_rasterize_fwd(const float* inst, const int* tile_start,
                                       const int* tile_count, int num_tiles,
                                       int tiles_x, int col_offset, float* out,
                                       int* walk, void* stream) {
  if (num_tiles <= 0) return 0;
  composite_fwd<<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      inst, tile_start, tile_count, tiles_x, col_offset, out, walk);
  return static_cast<int>(cudaGetLastError());
}
