// Tile compositing backward of the Gaussian rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel freesplat_tpu/ops/rasterizer.py::_backward_kernel
// (Pallas).  Same gradients, rebuilt for the GPU: the TPU kernel's
// log-space cumsums, 128-lane chunks, the (8, P) moment-basis matmul on
// the MXU and double-buffered DMA are TPU means and are gone.
//
// Design.  One thread block per 16x16 pixel tile, one thread per pixel
// (256 threads), as the forward (csrc/rasterize_fwd.cu).  Each pixel
// walks its instances back to front, from walk - 1 (the forward's
// residual: one past its last blended instance) down to 0.  The block
// walks from the largest walk of the tile, in batches of BATCH instances
// staged in shared memory, last batch first.  Per pixel and instance j
// (only where the forward blended j: j < walk, power <= 0 and
// alpha >= 1/255):
//   log T_j  = log T_{j+1} - log1p(-alpha_j)    (T before j, from the
//              final log T the forward wrote, as JAX does at l.542)
//   w_j      = alpha_j T_j
//   dalpha_j = (g.c_j) T_j - (S_j + dL/dlogT) / max(1 - alpha_j, 1e-6),
//              S_j = sum_{k>j} w_k (g.c_k), the strict suffix sum
//   dpow_j   = dalpha_j alpha_u_j where alpha_u_j = op exp(power) <= 0.99,
//              else 0 (the 0.99 clamp's deliberate zero subgradient)
// and the ten per-instance sums over the tile's pixels
//   dpow, dpow dx, dpow dy, dpow dx^2, dpow dy^2, dpow dx dy, w g (4)
// give d(mean xy, conic, opacity, rgb, depth).  The sums are reduced with
// warp shuffles (skipped when no lane of the warp contributes), the eight
// warp partials go through shared memory, and one thread per instance
// writes its dinst row.  Every instance belongs to exactly one tile, so
// no global atomics are needed.  Rows the walk never reaches (behind
// every pixel's last blend, or past the 16384 per-tile cap) are zeroed
// here, so the output needs no memset.
//
// What bounds it on the H100: the arithmetic per (pixel, instance) pair
// (two expf, one log1pf and ~40 flops) and the ten warp reductions per
// instance, not the bytes (40 B read and 40 B written per instance, 40 B
// read per pixel).
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, one per pixel
constexpr int NWARP = PIX / 32;
constexpr int NF = 10;            // mx my conic_a conic_b conic_c opacity r g b depth
constexpr int NS = 10;            // per-instance sums
constexpr int BATCH = 64;         // instances staged per round
constexpr int MAX_INST = 16384;   // per-tile cap
constexpr int OUT_CH = 5;         // r g b depth logT
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(PIX)
composite_bwd(const float* __restrict__ inst, const int* __restrict__ tile_start,
              const int* __restrict__ tile_count, int tiles_x,
              const float* __restrict__ fwd_out, const int* __restrict__ walk,
              const float* __restrict__ cot, float* __restrict__ dinst) {
  __shared__ float s_inst[BATCH * NF];
  __shared__ float s_part[NWARP][BATCH][NS];
  __shared__ int s_maxw;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const float px = (float)((t % tiles_x) * TILE + p % TILE);
  const float py = (float)((t / tiles_x) * TILE + p / TILE);
  const long long pix = (long long)t * PIX + p;

  const int my_walk = walk[pix];
  const float* g = cot + pix * OUT_CH;
  const float g0 = g[0], g1 = g[1], g2 = g[2], g3 = g[3], g_logt = g[4];
  float log_t = fwd_out[pix * OUT_CH + 4];  // log T after the current instance
  float suffix = 0.0f;                      // sum_{k>j} w_k (g.c_k)

  if (p == 0) s_maxw = 0;
  __syncthreads();
  const int wmax = __reduce_max_sync(FULL, (unsigned)my_walk);
  if (lane == 0) atomicMax(&s_maxw, wmax);
  __syncthreads();
  const int maxw = min(s_maxw, MAX_INST);

  for (int end = maxw; end > 0; end -= BATCH) {
    const int base = max(end - BATCH, 0);
    const int nb = end - base;
    __syncthreads();  // the previous round's readers are done
    const float* src = inst + (start + base) * NF;
    for (int k = p; k < nb * NF; k += PIX) s_inst[k] = src[k];
    __syncthreads();

    for (int jj = nb - 1; jj >= 0; --jj) {
      const int j = base + jj;
      float v[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) v[k] = 0.0f;
      bool contrib = false;
      if (j < my_walk) {
        const float* d = s_inst + jj * NF;
        const float dx = px - d[0];
        const float dy = py - d[1];
        const float power = -0.5f * (d[2] * dx * dx + d[4] * dy * dy) - d[3] * dx * dy;
        const float alpha_u = d[5] * expf(power);
        const float alpha = fminf(ALPHA_MAX, alpha_u);
        if (!(power > 0.0f || alpha < ALPHA_MIN)) {
          contrib = true;
          const float l1m = log1pf(-alpha);
          const float log_t0 = log_t - l1m;
          const float t_excl = expf(log_t0);
          const float w = alpha * t_excl;
          const float cg = g0 * d[6] + g1 * d[7] + g2 * d[8] + g3 * d[9];
          const float dalpha =
              cg * t_excl - (suffix + g_logt) / fmaxf(1.0f - alpha, 1e-6f);
          const float dpow = alpha_u <= ALPHA_MAX ? dalpha * alpha_u : 0.0f;
          const float pdx = dpow * dx;
          const float pdy = dpow * dy;
          v[0] = dpow;
          v[1] = pdx;
          v[2] = pdy;
          v[3] = pdx * dx;
          v[4] = pdy * dy;
          v[5] = pdx * dy;
          v[6] = w * g0;
          v[7] = w * g1;
          v[8] = w * g2;
          v[9] = w * g3;
          log_t = log_t0;
          suffix = suffix + w * cg;
        }
      }
      if (__any_sync(FULL, contrib)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int k = 0; k < NS; ++k) v[k] += __shfl_down_sync(FULL, v[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NS; ++k) s_part[warp][jj][k] = v[k];
      }
    }
    __syncthreads();

    if (p < nb) {
      float s[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) acc += s_part[w][p][k];
        s[k] = acc;
      }
      const float* d = s_inst + p * NF;
      const float op = d[5];
      float* row = dinst + (start + base + p) * NF;
      row[0] = d[2] * s[1] + d[3] * s[2];  // d mean x
      row[1] = d[4] * s[2] + d[3] * s[1];  // d mean y
      row[2] = -0.5f * s[3];               // d conic a
      row[3] = -s[5];                      // d conic b
      row[4] = -0.5f * s[4];               // d conic c
      row[5] = op > 0.0f ? s[0] / op : 0.0f;
      row[6] = s[6];
      row[7] = s[7];
      row[8] = s[8];
      row[9] = s[9];
    }
  }

  // Rows no pixel reached: behind every pixel's last blend or past the cap.
  float* rest = dinst + start * NF;
  for (long long k = (long long)maxw * NF + p; k < (long long)count * NF; k += PIX) rest[k] = 0.0f;
}

}  // namespace

// inst: (k, 10) f32; tile_start, tile_count: (num_tiles,) i32;
// fwd_out, cot: (num_tiles, 256, 5) f32; walk: (num_tiles, 256) i32;
// dinst: (k, 10) f32, every row written.  Launches on ``stream``; returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int freesplat_rasterize_bwd(const float* inst, const int* tile_start,
                                       const int* tile_count, int num_tiles,
                                       int tiles_x, const float* fwd_out,
                                       const int* walk, const float* cot,
                                       float* dinst, void* stream) {
  if (num_tiles <= 0) return 0;
  composite_bwd<<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      inst, tile_start, tile_count, tiles_x, fwd_out, walk, cot, dinst);
  return static_cast<int>(cudaGetLastError());
}
