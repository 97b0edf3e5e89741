// Stochastic row quantization, f32 rows -> int8 + one f32 scale a row, for
// Hopper (sm_90a).
//
// Replaces pytorchrec_tpu/ops/kernels/quantize.py::_quantize_kernel (the
// pl.pallas_call in quantize_rows_pallas). For each of n rows of e f32
// values with e uint32 rounding bits it writes
//   absmax = max_c |row_c|
//   scale  = absmax > 0 ? absmax / 127 : 1
//   u_c    = (bits_c >> 8) * 2^-24          (a logical shift: bits are uint32)
//   q_c    = clip(floor(row_c / scale + u_c), -127, 127)   as int8
// and scale. The classic quantized-row trainer requantizes every touched row
// of an int8 table through it once a step.
//
// Bound: each input read once and each output written once: the rows (4e
// bytes), the bits (4e), q (e) and the scale (4), 9e + 4 bytes a row. At the
// training step's shape (n = 851,968, e = 16) that is 126.1 MB: 0.0376 ms at
// 3.35 TB/s. A handful of operations a value are nothing beside it, so the
// kernel is bound by bytes.
//
// Design. The TPU kernel takes [256, e] blocks, padded to a whole block, with
// the row's max as a lane reduction. Here a group of g threads (g a power of
// two, the smallest >= e, at most 32) owns one row: thread j takes columns
// j, j + g, ...; a shuffle butterfly inside the group gives every thread the
// absmax (a max is exact in any order), and no row is padded. At e = 16 a
// warp covers two rows, so its loads of rows and bits are 128 contiguous
// bytes each. Both quotients are IEEE divisions (__fdiv_rn, not a product
// with a reciprocal) and the sum is __fadd_rn, as torch computes them, so q
// and scale agree with the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const float* __restrict__ rows, const uint32_t* __restrict__ bits,
                     int8_t* __restrict__ q, float* __restrict__ scale, long long n, int e,
                     int group) {
  const int sub = threadIdx.x & (group - 1);
  const long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) / group;
  // threads past the last row stay for the shuffles and load nothing
  const bool live = row < n;
  const float* src = rows + row * e;
  float absmax = 0.f;
  if (live)
    for (int c = sub; c < e; c += group) absmax = fmaxf(absmax, fabsf(__ldg(src + c)));
  for (int off = group >> 1; off; off >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(FULL, absmax, off, group));
  if (!live) return;
  const float s = absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;
  const uint32_t* b = bits + row * e;
  int8_t* dst = q + row * e;
  for (int c = sub; c < e; c += group) {
    const float u = (float)(__ldg(b + c) >> 8) * (1.f / 16777216.f);  // exact: 24 bits
    float v = floorf(__fadd_rn(__fdiv_rn(__ldg(src + c), s), u));
    v = fminf(fmaxf(v, -127.f), 127.f);
    dst[c] = (int8_t)(int)v;
  }
  if (sub == 0) scale[row] = s;
}

}  // namespace

extern "C" {

// rows [n, e] f32, bits [n, e] uint32, q [n, e] int8, scale [n] f32, all
// contiguous. Launch on `stream`; returns the cudaError_t (0 = success).
int quantize_rows_launch(const void* rows, const void* bits, void* q, void* scale, long long n,
                         int e, void* stream) {
  if (n < 0 || e < 1) return (int)cudaErrorInvalidValue;
  int group = 1;
  while (group < e && group < 32) group <<= 1;
  const long long blocks = (n * group + THREADS - 1) / THREADS;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  quantize_rows_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), static_cast<const uint32_t*>(bits),
      static_cast<int8_t*>(q), static_cast<float*>(scale), n, e, group);
  return (int)cudaGetLastError();
}

const char* quantize_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
