// Tile compositing backward of the Gaussian rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel freesplat_tpu/ops/rasterizer.py::_backward_kernel
// (Pallas).  Same gradients, rebuilt for the GPU: the TPU kernel's
// log-space cumsums, 128-lane chunks, the (8, P) moment-basis matmul on
// the MXU and double-buffered DMA are TPU means and are gone.
//
// Design.  One thread block per 16x16 pixel tile, one thread per pixel
// (256 threads), each warp an 8x4 pixel block, as the forward
// (csrc/rasterize_fwd.cu, tile_cull.cuh).  Each pixel walks its instances
// back to front, from walk - 1 (the forward's residual: one past its last
// blended instance) down to 0.  The block stages batches of BATCH
// instances in shared memory, last batch first, each thread one instance
// and its 8-bit warp mask.  Each warp starts at its own largest walk and
// visits only the instances whose mask bit it holds (a ballot over 32 at a
// time, highest first); the rest cost it nothing.  Per pixel and instance
// j (only where the forward blended j: j < walk, power <= 0 and
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
// give d(mean xy, conic, opacity, rgb, depth).
//
// Reduction.  A warp that visits an instance with any contributing lane
// reduces the ten sums transposed: at lane offset 16 each half keeps five
// sums and sends the other five (5 shuffles), then 5 -> 3 at offset 8,
// 3 -> 2 at 4, 2 -> 1 at 2 and a last add at 1: 12 shuffles instead of
// 50.  Sum k = 5 b4 + 3 b3 + 2 b2 + b1 then sits whole in the lanes of
// those bits (b4 = lane bit 16, ..., b1 = lane bit 2); ``SUM_LANES``
// marks one lane of each.  Those ten lanes write the warp's partial to shared
// memory (zeros when no lane contributed).  One thread per instance then
// adds the partials of the warps that visited it, in warp order, and
// writes its dinst row: the adds' order is fixed, so the kernel is
// deterministic, and every instance belongs to one tile, so no atomics.
// Rows the walk never reaches (behind every pixel's last blend, or past
// the 16384 per-tile cap) are zeroed here, so the output needs no memset.
//
// What bounds it on the H100: the (warp, instance) steps, each with two
// expf, one log1pf and ~40 flops per lane, and the shuffles of the
// reduction (one warp shuffle a clock per SM), not the bytes (40 B read
// and 40 B written per instance, 44 B read per pixel).  The per-warp
// start and the cull cut the steps; the transposed reduction cuts the
// shuffles a step fourfold.
#include <cuda_runtime.h>

#include "tile_cull.cuh"

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
// Lanes that hold a whole sum after the transposed reduction: 0 2 4 8 10
// (sums 0-4) and 16 18 20 24 26 (sums 5-9).
constexpr unsigned SUM_LANES = 0x05150515u;

// One level of the transposed reduction: lanes whose ``off`` bit is 0 keep
// the first ceil(N/2) of their N slots, the others the last floor(N/2)
// (the unused slot reads zero); each sends the partner what it does not
// keep.
template <int N>
__device__ __forceinline__ void halve(const float (&v)[N], float (&r)[(N + 1) / 2],
                                      int off, bool upper) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float lo = v[k];
    const float hi = k + H < N ? v[k + H] : 0.0f;
    const float keep = upper ? hi : lo;
    const float send = upper ? lo : hi;
    r[k] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

// Six blocks an SM (at most 40 registers a thread): the 768 tiles of a
// 384x512 view then fit in one wave (132 SMs x 6 = 792 slots), where the
// compiler's own choice (55 registers left 4 blocks an SM and a second, partial
// wave).
__global__ void __launch_bounds__(PIX, 6)
composite_bwd(const float* __restrict__ inst, const int* __restrict__ tile_start,
              const int* __restrict__ tile_count, int tiles_x, int col_offset,
              const float* __restrict__ fwd_out, const int* __restrict__ walk,
              const float* __restrict__ cot, float* __restrict__ dinst) {
  __shared__ float s_inst[BATCH * NF];
  __shared__ float s_part[NWARP][BATCH][NS];
  __shared__ unsigned char s_mask[BATCH];
  __shared__ int s_wmax[NWARP];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int p = tile_cull::pixel_of_thread(i);
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const float x0 = (float)((col_offset + t % tiles_x) * TILE);  // as the forward
  const float y0 = (float)((t / tiles_x) * TILE);
  const float px = x0 + (float)(p % TILE);
  const float py = y0 + (float)(p / TILE);
  const long long pix = (long long)t * PIX + p;

  const int my_walk = walk[pix];
  const float* g = cot + pix * OUT_CH;
  const float g0 = g[0], g1 = g[1], g2 = g[2], g3 = g[3], g_logt = g[4];
  float log_t = fwd_out[pix * OUT_CH + 4];  // log T after the current instance
  float suffix = 0.0f;                      // sum_{k>j} w_k (g.c_k)

  const int wmax = min((int)__reduce_max_sync(FULL, (unsigned)my_walk), MAX_INST);
  if (lane == 0) s_wmax[warp] = wmax;
  __syncthreads();
  int maxw = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) maxw = max(maxw, s_wmax[w]);

  for (int end = maxw; end > 0; end -= BATCH) {
    const int base = max(end - BATCH, 0);
    const int nb = end - base;
    __syncthreads();  // the previous round's readers are done
    if (i < nb) {
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

    // This warp's instances of the batch: [base, min(end, wmax)), top first.
    const int hi = min(end, wmax) - base;
    for (int c0 = (hi - 1) & ~31; c0 >= 0 && hi > 0; c0 -= 32) {
      const int jl = c0 + lane;
      unsigned bits = __ballot_sync(FULL, jl < hi && ((s_mask[min(jl, hi - 1)] >> warp) & 1u));
      while (bits) {
        const int top = 31 - __clz(bits);
        bits &= ~(1u << top);
        const int jj = c0 + top;
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
        float sum = 0.0f;  // this lane's whole sum, if it holds one
        if (__any_sync(FULL, contrib)) {
          float r5[5], r3[3], r2[2], r1[1];
          halve<10>(v, r5, 16, lane & 16);
          halve<5>(r5, r3, 8, lane & 8);
          halve<3>(r3, r2, 4, lane & 4);
          halve<2>(r2, r1, 2, lane & 2);
          sum = r1[0] + __shfl_xor_sync(FULL, r1[0], 1);
        }
        if ((SUM_LANES >> lane) & 1u) {
          const int k = 5 * ((lane >> 4) & 1) + 3 * ((lane >> 3) & 1) + 2 * ((lane >> 2) & 1) +
                        ((lane >> 1) & 1);
          s_part[warp][jj][k] = sum;
        }
      }
    }
    __syncthreads();

    if (i < nb) {
      // The warps that visited instance i: its mask bit, and i below their walk.
      const unsigned m = s_mask[i];
      float s[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) s[k] = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        if (((m >> w) & 1u) && base + i < s_wmax[w]) {
#pragma unroll
          for (int k = 0; k < NS; ++k) s[k] += s_part[w][i][k];
        }
      }
      const float* d = s_inst + i * NF;
      const float op = d[5];
      float* row = dinst + (start + base + i) * NF;
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
  for (long long k = (long long)maxw * NF + i; k < (long long)count * NF; k += PIX) rest[k] = 0.0f;
}

}  // namespace

// inst: (k, 10) f32; tile_start, tile_count: (num_tiles,) i32, tiles
// row-major over (num_tiles / tiles_x, tiles_x), the first column at
// image tile column col_offset (as the forward); fwd_out, cot:
// (num_tiles, 256, 5) f32; walk: (num_tiles, 256) i32; dinst: (k, 10)
// f32, every row written.  Launches on ``stream``; returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int freesplat_rasterize_bwd(const float* inst, const int* tile_start,
                                       const int* tile_count, int num_tiles,
                                       int tiles_x, int col_offset,
                                       const float* fwd_out, const int* walk,
                                       const float* cot, float* dinst, void* stream) {
  if (num_tiles <= 0) return 0;
  composite_bwd<<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      inst, tile_start, tile_count, tiles_x, col_offset, fwd_out, walk, cot, dinst);
  return static_cast<int>(cudaGetLastError());
}
