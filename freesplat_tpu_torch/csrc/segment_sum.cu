// Segment sum for the backward of a row gather, for Hopper (sm_90a).
//
//   out[r, :] = sum over k in [offsets[r], offsets[r + 1]) of src[order[k], :]
//
// added in increasing k, one destination row at a time.  ``order`` is a
// stable sort of the gather's index, so each row's contributions arrive
// in the order of the gathered rows that read it: the sum is the same on
// every run.  (``index_add_``, the backward of ``index_select``, adds them
// with float atomics in whatever order the threads arrive.)
//
// This is no counterpart of a TPU kernel: XLA's scatter-add on the TPU is
// deterministic, and this kernel gives the port the same property
// (``freesplat_tpu_torch/ops/gather.py`` routes the gathers of the train
// step through it).
//
// Design.  One warp per destination row, lanes over columns (up to four
// passes of 32 columns, held in registers), a serial loop over the
// segment.  The warp loads 32 entries of ``order`` at once and broadcasts
// them by shuffle, so the source loads of successive entries do not wait
// on each other's index.  No atomics and no shared memory; a row no entry
// reads is written as zeros.  The plain version
// (``ops/gather.py::segment_sum_plain``) adds in the same order, so the
// two agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // destination rows a block
constexpr int MAX_PASSES = 4;  // 32 columns a pass: up to 128 columns

template <int PASSES>
__global__ void __launch_bounds__(WARPS * 32)
segment_sum(const float* __restrict__ src, const long long* __restrict__ order,
            const long long* __restrict__ offsets, int rows, int cols,
            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp: r is the warp's
  const long long begin = __ldg(offsets + r);
  const long long end = __ldg(offsets + r + 1);
  float acc[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) acc[p] = 0.0f;
  for (long long base = begin; base < end; base += 32) {
    const int m = static_cast<int>(end - base < 32 ? end - base : 32);
    const long long mine = lane < m ? __ldg(order + base + lane) : 0;
#pragma unroll 4
    for (int t = 0; t < m; ++t) {
      const float* s = src + __shfl_sync(0xffffffffu, mine, t) * cols;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int c = lane + 32 * p;
        if (c < cols) acc[p] += __ldg(s + c);
      }
    }
  }
  float* o = out + r * cols;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int c = lane + 32 * p;
    if (c < cols) o[c] = acc[p];
  }
}

template <int PASSES>
void launch(const float* src, const long long* order, const long long* offsets, int rows,
            int cols, float* out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + WARPS - 1) / WARPS);
  segment_sum<PASSES><<<blocks, WARPS * 32, 0, stream>>>(src, order, offsets, rows, cols, out);
}

}  // namespace

extern "C" int freesplat_segment_sum(const float* src, const long long* order,
                                     const long long* offsets, int rows, int cols, float* out,
                                     void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (cols > 32 * MAX_PASSES) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((cols + 31) / 32) {
    case 1: launch<1>(src, order, offsets, rows, cols, out, s); break;
    case 2: launch<2>(src, order, offsets, rows, cols, out, s); break;
    case 3: launch<3>(src, order, offsets, rows, cols, out, s); break;
    default: launch<4>(src, order, offsets, rows, cols, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
