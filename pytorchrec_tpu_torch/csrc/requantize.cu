// Rowwise Adagrad and id-keyed stochastic requantization of int8 packed
// byte rows, for Hopper (sm_90a).
//
// Replaces pytorchrec_tpu/ops/kernels/quantize.py::_requantize_kernel (the
// pl.pallas_call in requantize_rows_pallas). For each of n permuted rows of W
// bytes, laid out q[0, e) || scale f32 || acc f32 || ..., with its summed
// grads g[e] f32 and its global id, it writes a new row of W bytes:
//   acc'  = acc + sum(g^2) / e
//   row_c = q_c * scale - lr * g_c / (sqrt(acc') + eps)
//   u_c   = (mix(id * 0x9E3779B1 + c * 0x85EBCA77 ^ salt) >> 8) * 2^-24
//   scale'= absmax(row) > 0 ? absmax(row) / 127 : 1
//   q'_c  = clip(floor(row_c / scale' + u_c), -127, 127)
// as q' || scale' || acc', then zero bytes to W (uint32 arithmetic wraps).
//
// Bound: each input byte the function needs read once and each output byte
// written once: the q || scale || acc bytes (e + 8), the grads (4e) and the
// id (4) of a row, and the whole new row (W). At the int8 training step's
// shape (n = 851,968, W = 128, e = 16) that is 187 MB: 0.056 ms at
// 3.35 TB/s. A few dozen operations a row are nothing beside it, so the
// kernel is bound by bytes.
//
// Design. The TPU kernel works on full-width [R, W] blocks because its
// vector unit wants 128 lanes and no narrow slices. Here one warp takes one
// row: lane j owns columns j, j + 32, ... of q and g; warp shuffles hand
// every lane each g_c^2 to sum in column order and find the absmax. The warp
// assembles the new row in shared memory (q' bytes, then scale' and acc'
// bytes, zeros elsewhere) and stores it as 32-bit words, so a 128-byte row
// is one coalesced store. Only the first
// e + 8 bytes of an input row are read. Every operation rounds as torch
// rounds it (__fmul_rn and friends: nvcc would otherwise contract
// q * scale - x into an FMA), and the sum of g^2 runs in column order, as
// the plain version and XLA's CPU reduction take it, so the rows agree with
// the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // rows a block
constexpr int MAX_WIDTH = 4096;      // bytes a row: WARPS * W bytes of shared memory
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t mix_u32(uint32_t x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

// 4 little-endian bytes at any alignment.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) | ((uint32_t)__ldg(p + 2) << 16) |
         ((uint32_t)__ldg(p + 3) << 24);
}

__global__ void __launch_bounds__(THREADS)
requantize_rows_kernel(const uint8_t* __restrict__ moved, const float* __restrict__ g,
                       const int* __restrict__ ids, uint8_t* __restrict__ out, long long n,
                       int w, int e, uint32_t salt, float lr, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= n) return;  // the whole warp: row is the same for its lanes
  const uint8_t* src = moved + row * w;
  const float* grow = g + row * e;
  const float scale = __uint_as_float(load_word(src + e));
  const float acc = __uint_as_float(load_word(src + e + 4));
  const uint32_t id = (uint32_t)__ldg(ids + row);

  // sum of g^2 from column 0 up, in order, as the plain version sums it:
  // every lane adds the same values, so every lane holds the sum
  float ss = 0.f;
  for (int c0 = 0; c0 < e; c0 += 32) {
    const float gc = c0 + lane < e ? __ldg(grow + c0 + lane) : 0.f;
    const float sq = __fmul_rn(gc, gc);
    for (int l = 0; l < min(32, e - c0); ++l) ss = __fadd_rn(ss, __shfl_sync(FULL, sq, l));
  }
  const float acc_new = __fadd_rn(acc, __fdiv_rn(ss, (float)e));
  const float denom = __fadd_rn(__fsqrt_rn(acc_new), eps);

  auto updated = [&](int c) {
    const float current = __fmul_rn((float)(int8_t)__ldg(src + c), scale);
    return __fsub_rn(current, __fdiv_rn(__fmul_rn(lr, __ldg(grow + c)), denom));
  };
  float absmax = 0.f;
  for (int c = lane; c < e; c += 32) absmax = fmaxf(absmax, fabsf(updated(c)));
  for (int off = 16; off; off >>= 1) absmax = fmaxf(absmax, __shfl_xor_sync(FULL, absmax, off));
  const float scale_new = absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;

  uint8_t* stage = smem + warp * w;
  uint32_t* stage_words = reinterpret_cast<uint32_t*>(stage);
  for (int k = lane; k < w / 4; k += 32) stage_words[k] = 0u;
  __syncwarp();
  for (int c = lane; c < e; c += 32) {
    const uint32_t bits = mix_u32((id * 0x9E3779B1u + (uint32_t)c * 0x85EBCA77u) ^ salt);
    const float u = (float)(bits >> 8) * (1.f / 16777216.f);  // exact: 24 bits, power of 2
    float q = floorf(__fadd_rn(__fdiv_rn(updated(c), scale_new), u));
    q = fminf(fmaxf(q, -127.f), 127.f);
    stage[c] = (uint8_t)(int8_t)(int)q;
  }
  if (lane < 8) {
    const uint32_t word = __float_as_uint(lane < 4 ? scale_new : acc_new);
    stage[e + lane] = (uint8_t)(word >> (8 * (lane & 3)));
  }
  __syncwarp();
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + row * w);
  for (int k = lane; k < w / 4; k += 32) dst[k] = stage_words[k];
}

}  // namespace

extern "C" {

// moved [n, w] u8 (w % 4 == 0, 4-byte aligned), g [n, e] f32, ids [n] int32,
// out [n, w] u8, all contiguous; e + 8 <= w <= MAX_WIDTH. Launch on `stream`;
// returns the cudaError_t (0 = success).
int requantize_rows_launch(const void* moved, const void* g, const void* ids, void* out,
                           long long n, int w, int e, uint32_t salt, float lr, float eps,
                           void* stream) {
  const long long blocks = (n + WARPS - 1) / WARPS;
  if (n < 0 || e < 1 || w % 4 || e + 8 > w || w > MAX_WIDTH || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  requantize_rows_kernel<<<(unsigned)blocks, THREADS, (size_t)WARPS * w, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(moved), static_cast<const float*>(g),
      static_cast<const int*>(ids), static_cast<uint8_t*>(out), n, w, e, salt, lr, eps);
  return (int)cudaGetLastError();
}

int requantize_max_width() { return MAX_WIDTH; }

const char* requantize_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
