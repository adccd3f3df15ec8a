// Plane-sweep cost volume with its MLP head, for Hopper (sm_90a).
//
// For every view b, pixel n and depth plane d:
//
//   cam      = ray[b, n] * depth[b, d]
//   p_s      = proj[b, s] @ (cam, 1)                     each source s
//   warped_s = bilinear(src[b, s], p_s.xy / (p_s.z + eps))  zero padding
//   dot_s    = <warped_s, cur[b, n]> * (p_s.z > 0)
//   k        = #{s : dot_s != 0} + 1e-8
//   x        = (sum of warped_s over dot_s != 0) / k, (sum of dot_s) / k
//   out[b, n, d] = Dense(32->1)(lrelu(Dense(32->32)(lrelu(Dense(49->32)(x)))))
//
// the ``avg_mlp`` similarity of ``models/cost_volume.py::CostVolume``
// (whose plane-chunk loop is the plain version, and the path of every call
// that carries a gradient or lies on the CPU).  Only the (B, h, w, D)
// volume reaches device memory: no tap, warped feature or head input.
//
// This is no counterpart of a TPU kernel: the JAX package sweeps with XLA's
// gathers (``freesplat_tpu/models/cost_volume.py``).  ``gather_rows.cu``
// was the TPU's probe for such a kernel.
//
// Arithmetic as the plain path's, bit for bit: the same products and
// quotients, each rounded on its own (``-fmad=false``), the taps added in
// the same order, the dot in the order of PyTorch's sum, the sources in
// order, and the projection's and the head's multiply-adds in the order of
// the cuBLAS kernels the plain path runs (read on the H100, torch 2.11).
// It matters: a count of sources off by one (a dot that rounds to 0 in one
// order only) moves a row by a large step, and the head's last ulps move
// the rendered scene by more than the benchmark's limits allow.  No
// atomics: the same inputs give the same bits.
//
// What bounds it on the H100.  At the whole-scene chunk (15 views x 4
// sources x 128 planes x 96 x 128 pixels, c = 48) the taps read 4 x 192 B a
// sample, 73 GB a chunk, from L1 and L2 (a view's sources, 4 x 2.4 MB, stay
// in the 50 MB L2); the head does 2,608 multiply-adds a (pixel, plane), 62
// G a chunk.  Device memory moves well under 1 GB.
//
// Design.  A block of 128 threads takes 32 consecutive pixels of one view
// and walks the planes 4 at a time.  Gather: 4 lanes a pixel, each holding
// c / 4 channels of the current feature for the whole walk; a tap is read
// as 16-byte loads, the 4 lanes of a pixel on 64 contiguous bytes; the dot
// is summed across them by shuffles.  The 4 planes' head inputs go to shared
// memory, and then each thread runs the head for one (pixel, plane), the
// weights (2.7 k floats) in shared memory, read as broadcast float4s.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 4;     // threads a pixel in the gather
constexpr int PIXELS = 32;   // consecutive pixels a block
constexpr int PLANES = 4;    // planes a step: one head row a thread
constexpr int THREADS = PIXELS * LANES;
constexpr int ROWS = PIXELS * PLANES;
static_assert(ROWS == THREADS, "one head row a thread");
constexpr int HID = 32;      // the head's hidden width
constexpr int MAX_SOURCES = 16;
constexpr float EPS = 1e-8f;  // the projection's guard
constexpr float DENOM_EPS = 1e-8f;  // the view average's
constexpr float SLOPE = 0.01f;  // LeakyReLU

__device__ __forceinline__ float lrelu(float x) { return x > 0.0f ? x : x * SLOPE; }

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The sum of a pixel's c products in the order of PyTorch's sum over the
// last dimension, so that a dot that rounds to exactly 0 there (the count of
// sources is then one less) rounds to 0 here.  ATen's reduction of c = 32
// to 64 contiguous floats: lane t of a warp adds products t and t + 32 (if
// any), then a shuffle tree adds lane t + 16, 8, 4, 2, 1.  Lane l of a pixel
// holds products 4 l + j + 16 k, so lanes t < 16 and t + 16 are two of this
// lane's float4s, t + 8 is lane l ^ 2's, t + 4 lane l ^ 1's, and the last
// two steps lie inside a float4.
template <int V4>
__device__ __forceinline__ float dot_in_torch_order(const float4 (&p)[V4]) {
  static_assert(V4 >= 2 && V4 <= 4, "c from 32 to 64");
  float4 a = p[0], b = p[1];
  if constexpr (V4 > 2) a = add4(a, p[2]);
  if constexpr (V4 > 3) b = add4(b, p[3]);
  float4 s = add4(a, b);
  s = add4(s, make_float4(__shfl_xor_sync(0xffffffffu, s.x, 2), __shfl_xor_sync(0xffffffffu, s.y, 2),
                          __shfl_xor_sync(0xffffffffu, s.z, 2), __shfl_xor_sync(0xffffffffu, s.w, 2)));
  s = add4(s, make_float4(__shfl_xor_sync(0xffffffffu, s.x, 1), __shfl_xor_sync(0xffffffffu, s.y, 1),
                          __shfl_xor_sync(0xffffffffu, s.z, 1), __shfl_xor_sync(0xffffffffu, s.w, 1)));
  return (s.x + s.z) + (s.y + s.w);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 4)
plane_sweep(const float* __restrict__ cur, const float* __restrict__ src,
            const float* __restrict__ depths, const float* __restrict__ rays,
            const float* __restrict__ proj, const float* __restrict__ head, int S,
            int H, int W, int D, float* __restrict__ out) {
  static_assert(C % (4 * LANES) == 0, "c a multiple of 16");
  constexpr int V4 = C / (4 * LANES);  // float4s a lane
  constexpr int K = C + 1;             // head inputs: the features and the dot
  constexpr int W1 = 0, B1 = W1 + K * HID, W2 = B1 + HID, B2 = W2 + HID * HID,
                W3 = B2 + HID, B3 = W3 + HID, HEAD = B3 + 1;
  __shared__ __align__(16) float s_head[(HEAD + 3) / 4 * 4];
  __shared__ float s_proj[MAX_SOURCES * 12];
  __shared__ float s_x[K][ROWS + 1];

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int N = H * W;
  for (int i = t; i < HEAD; i += THREADS) s_head[i] = __ldg(head + i);
  for (int i = t; i < S * 12; i += THREADS) s_proj[i] = __ldg(proj + b * S * 12 + i);

  // Gather role: pixel g of the block, channels 4 l + 16 k .. + 3.
  const int g = t / LANES, l = t % LANES;
  const int n = blockIdx.x * PIXELS + g;
  const int nc = n < N ? n : N - 1;  // a ragged tile's spare pixels repeat the last
  float4 cf[V4];
  const float* cur_row = cur + (static_cast<long long>(b) * N + nc) * C + 4 * l;
#pragma unroll
  for (int k = 0; k < V4; ++k)
    cf[k] = __ldg(reinterpret_cast<const float4*>(cur_row + 16 * k));
  const float* ray = rays + (static_cast<long long>(b) * N + nc) * 3;
  const float rx = __ldg(ray), ry = __ldg(ray + 1), rz = __ldg(ray + 2);
  const float* src_b = src + static_cast<long long>(b) * S * N * C + 4 * l;
  const float Wf = static_cast<float>(W), Hf = static_cast<float>(H);
  // Head role: row t is pixel t / PLANES, plane t % PLANES of the step.
  const int hn = blockIdx.x * PIXELS + t / PLANES;
  float* out_row = out + (static_cast<long long>(b) * N + (hn < N ? hn : 0)) * D;
  __syncthreads();

  for (int d0 = 0; d0 < D; d0 += PLANES) {
    for (int p = 0; p < PLANES; ++p) {
      const float depth = __ldg(depths + b * D + min(d0 + p, D - 1));
      const float cx = rx * depth, cy = ry * depth, cz = rz * depth;
      float4 fsum[V4];
#pragma unroll
      for (int k = 0; k < V4; ++k) fsum[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float dsum = 0.0f, cnt = 0.0f;
      for (int s = 0; s < S; ++s) {
        const float* P = s_proj + s * 12;
        const float px = fmaf(P[2], cz, fmaf(P[1], cy, P[0] * cx)) + P[3];
        const float py = fmaf(P[6], cz, fmaf(P[5], cy, P[4] * cx)) + P[7];
        const float pz = fmaf(P[10], cz, fmaf(P[9], cy, P[8] * cx)) + P[11];
        const float scale = fabsf(pz) > EPS ? 1.0f / (pz + EPS) : 1.0f;
        const float x = px * scale - 0.5f, y = py * scale - 0.5f;
        const float x0 = floorf(x), y0 = floorf(y);
        const float wx = x - x0, wy = y - y0;
        const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
        const bool ix0 = x0 >= 0.0f && x0 < Wf, ix1 = x1 >= 0.0f && x1 < Wf;
        const bool iy0 = y0 >= 0.0f && y0 < Hf, iy1 = y1 >= 0.0f && y1 < Hf;
        // The taps in bilinear_sample's order; a tap off the map weighs 0.
        const bool in[4] = {ix0 && iy0, ix1 && iy0, ix0 && iy1, ix1 && iy1};
        const float wt[4] = {((1.0f - wx) * (1.0f - wy)) * (in[0] ? 1.0f : 0.0f),
                             (wx * (1.0f - wy)) * (in[1] ? 1.0f : 0.0f),
                             ((1.0f - wx) * wy) * (in[2] ? 1.0f : 0.0f),
                             (wx * wy) * (in[3] ? 1.0f : 0.0f)};
        const int xi = static_cast<int>(fminf(fmaxf(x0, -1.0f), Wf));
        const int yi = static_cast<int>(fminf(fmaxf(y0, -1.0f), Hf));
        const long long base = (static_cast<long long>(s) * N + yi * W + xi) * C;
        const long long off[4] = {base, base + C, base + static_cast<long long>(W) * C,
                                  base + static_cast<long long>(W + 1) * C};
        float4 tap[4][V4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < V4; ++k)
            tap[q][k] = in[q] ? __ldg(reinterpret_cast<const float4*>(src_b + off[q] + 16 * k))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 warped[V4], prod[V4];
#pragma unroll
        for (int k = 0; k < V4; ++k) {
          warped[k] = add4(add4(add4(scale4(tap[0][k], wt[0]), scale4(tap[1][k], wt[1])),
                                scale4(tap[2][k], wt[2])),
                           scale4(tap[3][k], wt[3]));
          prod[k] = make_float4(warped[k].x * cf[k].x, warped[k].y * cf[k].y,
                                warped[k].z * cf[k].z, warped[k].w * cf[k].w);
        }
        const float dot = dot_in_torch_order<V4>(prod) * (pz > 0.0f ? 1.0f : 0.0f);
        dsum = dsum + dot;
        if (dot != 0.0f) {
          cnt = cnt + 1.0f;
#pragma unroll
          for (int k = 0; k < V4; ++k) fsum[k] = add4(fsum[k], warped[k]);
        }
      }
      const float denom = cnt + DENOM_EPS;
      const int r = g * PLANES + p;
#pragma unroll
      for (int k = 0; k < V4; ++k) {
        const int c0 = 4 * l + 16 * k;
        s_x[c0][r] = fsum[k].x / denom;
        s_x[c0 + 1][r] = fsum[k].y / denom;
        s_x[c0 + 2][r] = fsum[k].z / denom;
        s_x[c0 + 3][r] = fsum[k].w / denom;
      }
      if (l == 0) s_x[C][r] = dsum / denom;
    }
    __syncthreads();

    // The head for row t: Dense(K -> 32), LeakyReLU, Dense(32 -> 32),
    // LeakyReLU, Dense(32 -> 1); each sum from 0 over k in order by fmaf,
    // the bias added last, as cuBLAS's kernels for these shapes add.
    float h1[HID];
#pragma unroll
    for (int j = 0; j < HID; ++j) h1[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float xk = s_x[k][t];
      const float4* w = reinterpret_cast<const float4*>(s_head + W1 + k * HID);
#pragma unroll
      for (int j = 0; j < HID / 4; ++j) {
        const float4 wj = w[j];
        h1[4 * j] = fmaf(wj.x, xk, h1[4 * j]);
        h1[4 * j + 1] = fmaf(wj.y, xk, h1[4 * j + 1]);
        h1[4 * j + 2] = fmaf(wj.z, xk, h1[4 * j + 2]);
        h1[4 * j + 3] = fmaf(wj.w, xk, h1[4 * j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < HID; ++j) h1[j] = lrelu(h1[j] + s_head[B1 + j]);
    float h2[HID];
#pragma unroll
    for (int j = 0; j < HID; ++j) h2[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < HID; ++k) {
      const float4* w = reinterpret_cast<const float4*>(s_head + W2 + k * HID);
#pragma unroll
      for (int j = 0; j < HID / 4; ++j) {
        const float4 wj = w[j];
        h2[4 * j] = fmaf(wj.x, h1[k], h2[4 * j]);
        h2[4 * j + 1] = fmaf(wj.y, h1[k], h2[4 * j + 1]);
        h2[4 * j + 2] = fmaf(wj.z, h1[k], h2[4 * j + 2]);
        h2[4 * j + 3] = fmaf(wj.w, h1[k], h2[4 * j + 3]);
      }
    }
    // cuBLAS sums the single output of the last layer in two halves.
    float o[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < HID; ++k)
      o[k / (HID / 2)] = fmaf(s_head[W3 + k], lrelu(h2[k] + s_head[B2 + k]), o[k / (HID / 2)]);
    const int d = d0 + t % PLANES;
    if (hn < N && d < D) out_row[d] = (o[0] + o[1]) + s_head[B3];
    __syncthreads();
  }
}

template <int C>
int launch(const float* cur, const float* src, const float* depths, const float* rays,
           const float* proj, const float* head, int B, int S, int H, int W, int D,
           float* out, cudaStream_t stream) {
  const int N = H * W;
  const dim3 grid((N + PIXELS - 1) / PIXELS, B);
  plane_sweep<C><<<grid, THREADS, 0, stream>>>(cur, src, depths, rays, proj, head, S, H, W,
                                               D, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cur (B, H*W, C), src (B, S, H*W, C), depths (B, D), rays (B, H*W, 3), proj
// (B, S, 3, 4), head: [W1^T (C+1, 32), b1 (32), W2^T (32, 32), b2 (32), w3
// (32), b3 (1)]; out (B, H*W, D).  All float32, contiguous, 16-byte aligned
// cur and src.  Returns a cudaError_t: cudaErrorInvalidValue (1) for a C or
// an S the kernel was not built for.
extern "C" int freesplat_plane_sweep(const float* cur, const float* src, const float* depths,
                                     const float* rays, const float* proj, const float* head,
                                     int B, int S, int H, int W, int C, int D, float* out,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || D <= 0) return 0;
  if (S <= 0 || S > MAX_SOURCES) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Every configuration matches at c = 48 (``matching_dim``).
  if (C != 48) return static_cast<int>(cudaErrorInvalidValue);
  return launch<48>(cur, src, depths, rays, proj, head, B, S, H, W, D, out, s);
}
