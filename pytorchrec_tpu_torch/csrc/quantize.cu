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
// and scale. The bits come in two forms, two instances of one kernel:
//   keyed: the kernel makes them from the row's global id (int32, read as
//          uint32) and the per-step salt, bits_c = id_keyed_bits(id, c,
//          salt) of id_hash.cuh. The salt is read from a device word (one
//          uint32), so a CUDA graph that captured the launch reads each
//          step's salt at replay. The classic quantized-row trainer runs this
//          form once a step on each int8 table, so no pass over [n, e] bits
//          runs before it.
//   given: bits [n, e] uint32 from memory, the TPU kernel's own contract.
//
// Bound: each input read once and each output written once. Keyed: the rows
// (4e bytes) and the id (4) read, q (e) and the scale (4) written, 5e + 8
// bytes a row; at the training step's shape (n = 851,968, e = 16) 75.0 MB,
// 0.0224 ms at 3.35 TB/s. Given: 9e + 4 bytes a row, 126.1 MB, 0.0376 ms.
// The keyed form's arithmetic (the hash, about 15 integer operations, and an
// IEEE division a value) is small beside the bytes at the card's integer
// rate, but B3 became issue-bound on the same hash and divisions.
//
// Design. The TPU kernel takes [256, e] blocks, padded to a whole block, with
// the row's max as a lane reduction. Here a group of G lanes (a power of two,
// at most 32) owns one row, 32 / G rows a warp, and no row is padded.
//   words (e % 4 == 0, e <= 128, 16-byte aligned rows and bits): lane j of
//     the group holds word j of 4 columns: it reads it once with one 16-byte
//     load (and the given bits with another), keeps it in registers from the
//     absmax to the rounding and stores its 4 q bytes as one 32-bit word. At
//     e = 16, 4 lanes a row and 8 rows a warp: the warp reads 512 contiguous
//     bytes of rows and writes 128 of q.
//   scalar (any other e): lane j takes columns j, j + G, ... one at a time
//     and reads the row twice (absmax, then values); e = 1 and 7 take it.
// A shuffle butterfly inside the group gives every lane the absmax (a max is
// exact in any order). Both quotients are IEEE divisions (__fdiv_rn, not a
// product with a reciprocal) and the sum is __fadd_rn, as torch computes
// them, so q and scale agree with the plain version bit for bit. The wrapper
// (ops/kernels/quantize.py::quantize_geometry) picks G and the path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "id_hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t quantize_value(float x, float s, uint32_t bits) {
  const float u = (float)(bits >> 8) * (1.f / 16777216.f);  // exact: 24 bits, a power of 2
  float v = floorf(__fadd_rn(__fdiv_rn(x, s), u));
  v = fminf(fmaxf(v, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)v;
}

__device__ __forceinline__ float group_max(float v, int group) {
  for (int off = group >> 1; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off, group));
  return v;
}

template <bool KEYED>
__global__ void __launch_bounds__(THREADS)
quantize_rows_words(const float* __restrict__ rows, const uint32_t* __restrict__ bits,
                    const int* __restrict__ ids, const uint32_t* __restrict__ salt_word,
                    int8_t* __restrict__ q, float* __restrict__ scale, long long n, int e,
                    int group) {
  const int glane = threadIdx.x & (group - 1);
  const long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) / group;
  // lanes past the last row or the row's last word stay for the shuffles and
  // load nothing
  const bool live = row < n, holds = live && glane < (e >> 2);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (holds) v = __ldg(reinterpret_cast<const float4*>(rows + row * e) + glane);
  const float absmax =
      group_max(fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))), group);
  if (!live) return;
  const float sc = absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;
  if (holds) {
    uint4 b;
    if constexpr (KEYED) {
      const uint32_t key = id_key((uint32_t)__ldg(ids + row)), c = 4u * glane;
      const uint32_t salt = __ldg(salt_word);
      b = make_uint4(id_keyed_bits(key, c, salt), id_keyed_bits(key, c + 1, salt),
                     id_keyed_bits(key, c + 2, salt), id_keyed_bits(key, c + 3, salt));
    } else {
      b = __ldg(reinterpret_cast<const uint4*>(bits + row * e) + glane);
    }
    reinterpret_cast<uint32_t*>(q + row * e)[glane] =
        quantize_value(v.x, sc, b.x) | (quantize_value(v.y, sc, b.y) << 8) |
        (quantize_value(v.z, sc, b.z) << 16) | (quantize_value(v.w, sc, b.w) << 24);
  }
  if (glane == 0) scale[row] = sc;
}

template <bool KEYED>
__global__ void __launch_bounds__(THREADS)
quantize_rows_scalar(const float* __restrict__ rows, const uint32_t* __restrict__ bits,
                     const int* __restrict__ ids, const uint32_t* __restrict__ salt_word,
                     int8_t* __restrict__ q, float* __restrict__ scale, long long n, int e,
                     int group) {
  const int sub = threadIdx.x & (group - 1);
  const long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) / group;
  const bool live = row < n;
  const float* src = rows + row * e;
  float absmax = 0.f;
  if (live)
    for (int c = sub; c < e; c += group) absmax = fmaxf(absmax, fabsf(__ldg(src + c)));
  absmax = group_max(absmax, group);
  if (!live) return;
  const float sc = absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;
  const uint32_t key = KEYED ? id_key((uint32_t)__ldg(ids + row)) : 0u;
  const uint32_t salt = KEYED ? __ldg(salt_word) : 0u;
  int8_t* dst = q + row * e;
  for (int c = sub; c < e; c += group) {
    const uint32_t b = KEYED ? id_keyed_bits(key, (uint32_t)c, salt) : __ldg(bits + row * e + c);
    dst[c] = (int8_t)(uint8_t)quantize_value(__ldg(src + c), sc, b);
  }
  if (sub == 0) scale[row] = sc;
}

bool power_of_two(int g) { return g >= 1 && g <= 32 && (g & (g - 1)) == 0; }

using Kernel = void (*)(const float*, const uint32_t*, const int*, const uint32_t*, int8_t*,
                        float*, long long, int, int);

// The instance of a (keyed, words) pair: words false the scalar path, true
// the words path.
Kernel instance(bool keyed, bool words) {
  if (words) return keyed ? quantize_rows_words<true> : quantize_rows_words<false>;
  return keyed ? quantize_rows_scalar<true> : quantize_rows_scalar<false>;
}

}  // namespace

extern "C" {

// rows [n, e] f32, q [n, e] int8, scale [n] f32, all contiguous; exactly one
// of bits ([n, e] uint32, contiguous: the given form) and ids ([n] int32:
// the keyed form, with salt: one uint32 word on the device) is not null.
// group lanes a row (a power of two
// <= 32); words 0 takes the scalar path, 1 the words path (e % 4 == 0,
// e <= 4 * group, so e <= 128; rows and bits 16-byte aligned, q 4-byte
// aligned).
// Launch on `stream`; returns the cudaError_t (0 = success).
int quantize_rows_launch(const void* rows, const void* bits, const void* ids, const void* salt,
                         void* q, void* scale, long long n, int e, int group, int words,
                         void* stream) {
  const bool keyed = ids != nullptr;
  if (n < 0 || e < 1 || !power_of_two(group) || keyed == (bits != nullptr) ||
      keyed != (salt != nullptr) || reinterpret_cast<uintptr_t>(salt) % 4 ||
      (words != 0 && words != 1))
    return (int)cudaErrorInvalidValue;
  if (words && (e % 4 || 4 * group < e ||
                reinterpret_cast<uintptr_t>(rows) % 16 || reinterpret_cast<uintptr_t>(q) % 4 ||
                (!keyed && reinterpret_cast<uintptr_t>(bits) % 16)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n * group + THREADS - 1) / THREADS;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Kernel kernel = instance(keyed, words != 0);
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), static_cast<const uint32_t*>(bits),
      static_cast<const int*>(ids), static_cast<const uint32_t*>(salt), static_cast<int8_t*>(q),
      static_cast<float*>(scale), n, e, group);
  return (int)cudaGetLastError();
}

// Registers a thread and local memory (stack and spills) a thread of the
// (keyed, words) instance; returns the cudaError_t.
int quantize_kernel_attributes(int keyed, int words, int* registers, int* local_bytes) {
  const Kernel kernel = instance(keyed != 0, words != 0);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaSuccess;
}

const char* quantize_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
