// Tile compositing forward of the Gaussian rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel freesplat_tpu/ops/rasterizer.py::_forward_kernel
// (Pallas).  Same outputs, rebuilt for the GPU rather than carried over:
// the TPU kernel's log-space cumsum on the MXU, 128-lane chunks and
// double-buffered DMA are TPU means and are gone.
//
// Design.  One thread block per 16x16 pixel tile, one thread per pixel
// (256 threads).  The block walks its tile's instances, already sorted
// front to back by depth, in batches of BATCH: all threads copy a batch
// (BATCH x 10 floats, contiguous) into shared memory with coalesced loads,
// then every thread blends the batch sequentially for its own pixel.
// The block stops once every pixel has terminated (__syncthreads_count).
//
// Semantics, per pixel and instance, as the TPU kernel and the CUDA
// rasterizer spec:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, with integer pixel
//           coordinates px = tx*16 + i%16, py = ty*16 + i/16 (no +0.5);
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
// What bounds it on the H100: the instance reads.  Every tile pass reads
// 40 B per instance from L2/DRAM (about 47 MB at the 384x512 slice shape,
// ~1.2M instances) and writes 20 B per pixel; the arithmetic per
// (pixel, instance) pair is two expf, one log1pf and ~20 flops.  Staging a
// batch in shared memory makes each instance one coalesced read per block
// instead of 256 reads, and the early exit skips the instances behind
// opaque surfaces.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, one per pixel
constexpr int NF = 10;            // mx my conic_a conic_b conic_c opacity r g b depth
constexpr int BATCH = 256;        // instances staged per round
constexpr int MAX_INST = 16384;   // per-tile cap
constexpr int OUT_CH = 5;         // r g b depth logT
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

__global__ void __launch_bounds__(PIX)
composite_fwd(const float* __restrict__ inst, const int* __restrict__ tile_start,
              const int* __restrict__ tile_count, int tiles_x,
              float* __restrict__ out, int* __restrict__ walk) {
  __shared__ float s_inst[BATCH * NF];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const long long start = tile_start[t];
  const int cnt = min(tile_count[t], MAX_INST);
  const float px = (float)((t % tiles_x) * TILE + p % TILE);
  const float py = (float)((t / tiles_x) * TILE + p / TILE);

  float log_t = 0.0f;  // log transmittance over blended instances
  float trans = 1.0f;  // expf(log_t)
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int walked = 0;  // one past the last blended instance
  bool done = false;

  for (int base = 0; base < cnt; base += BATCH) {
    // Also the barrier that keeps the previous batch alive until read.
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(BATCH, cnt - base);
    const float* src = inst + (start + base) * NF;
    for (int k = p; k < nb * NF; k += PIX) s_inst[k] = src[k];
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < nb; ++j) {
      const float* d = s_inst + j * NF;
      const float dx = px - d[0];
      const float dy = py - d[1];
      const float power = -0.5f * (d[2] * dx * dx + d[4] * dy * dy) - d[3] * dx * dy;
      const float alpha = fminf(ALPHA_MAX, d[5] * expf(power));
      if (power > 0.0f || alpha < ALPHA_MIN) continue;
      const float log_t_next = log_t + log1pf(-alpha);
      const float trans_next = expf(log_t_next);
      if (trans_next < T_EPS) {
        done = true;
        break;
      }
      const float w = alpha * trans;
      acc_r = acc_r + w * d[6];
      acc_g = acc_g + w * d[7];
      acc_b = acc_b + w * d[8];
      acc_d = acc_d + w * d[9];
      log_t = log_t_next;
      trans = trans_next;
      walked = base + j + 1;
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

// inst: (k, 10) f32; tile_start, tile_count: (num_tiles,) i32;
// out: (num_tiles, 256, 5) f32; walk: (num_tiles, 256) i32.  Launches on
// ``stream``; returns cudaGetLastError() of the launch (0 on success).
extern "C" int freesplat_rasterize_fwd(const float* inst, const int* tile_start,
                                       const int* tile_count, int num_tiles,
                                       int tiles_x, float* out, int* walk,
                                       void* stream) {
  if (num_tiles <= 0) return 0;
  composite_fwd<<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      inst, tile_start, tile_count, tiles_x, out, walk);
  return static_cast<int>(cudaGetLastError());
}
