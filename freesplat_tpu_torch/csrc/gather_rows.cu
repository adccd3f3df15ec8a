// Row gather o[r, l] = x[idx[r, l], l], for Hopper (sm_90a).
//
// Replaces the TPU kernel freesplat_tpu/scripts/probe_r3.py::probe_gather.k
// (Pallas): ``take_along_axis(x, idx, axis=0)`` inside one kernel, the
// hardware probe for a fused plane-sweep kernel that gathers from a table
// of hw = 96 * 128 = 12288 rows.
//
// Index semantics are jnp's, which the Pallas interpret run shares: a
// negative index wraps (idx + rows); an index outside [-rows, rows) gives
// a quiet NaN.
//
// Design.  The TPU kernel holds the whole table in VMEM.  Here the largest
// probe table, 12416 x 192 x 4 B = 9.5 MB, does not fit in shared memory
// (at most 227 KB a block) but does fit in the 50 MB L2, so the kernel
// reads ``x`` straight through the read-only path and lets L2 hold it.
// One thread per output element in row-major order: the ``idx`` reads and
// the ``o`` writes of a warp are 128 contiguous bytes each; the ``x`` reads
// land on 32 random rows, one 32 B sector each for 4 useful bytes.
//
// What bounds it on the H100: bytes.  Each element reads one index and one
// value and writes one value, 12 B, about 1.5 operations; the bound is the
// 12 B at 3.35 TB/s (8.5 us at 12416 x 192).  The random ``x`` sectors come
// from L2, not from device memory, after the first touch; staging column
// slabs of ``x`` in shared memory would cut that traffic and is left for
// later.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_rows(const float* __restrict__ x, const int* __restrict__ idx, int rows,
            int lanes, long long n, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n) return;
  const int l = static_cast<int>(e % lanes);
  int r = __ldg(idx + e);
  if (r < 0) r += rows;
  out[e] = (r >= 0 && r < rows)
               ? __ldg(x + static_cast<long long>(r) * lanes + l)
               : __int_as_float(0x7fc00000);  // jnp's fill value: a quiet NaN
}

}  // namespace

extern "C" int freesplat_gather_rows(const float* x, const int* idx, int rows,
                                     int lanes, float* out, void* stream) {
  const long long n = static_cast<long long>(rows) * lanes;
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  gather_rows<<<static_cast<unsigned>(blocks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(x, idx, rows, lanes, n, out);
  return static_cast<int>(cudaGetLastError());
}
