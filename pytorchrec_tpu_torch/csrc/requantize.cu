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
//           (id_hash.cuh)
//   scale'= absmax(row) > 0 ? absmax(row) / 127 : 1
//   q'_c  = clip(floor(row_c / scale' + u_c), -127, 127)
// as q' || scale' || acc', then zero bytes to W (uint32 arithmetic wraps).
// The salt is read from a device word (one uint32), not passed by value, so
// a CUDA graph that captured the launch reads each step's salt at replay.
//
// Bound: each input byte the function needs read once and each output byte
// written once: the q || scale || acc bytes (e + 8), the grads (4e) and the
// id (4) of a row, and the whole new row (W). At the int8 training step's
// shape (n = 851,968, W = 128, e = 16) that is 187 MB: 0.056 ms at
// 3.35 TB/s. The arithmetic is about 50 instructions a column (two IEEE
// divisions, the hash, the rounding), 800 a row at e = 16, and on the H100
// it sets the pace: 8 lanes a row with 4 of them idle ran 1.65x slower than
// 4 lanes, while more blocks an SM and loading the next tile ahead did not
// help (PERF.md). So the design spends no lane on idle columns and
// no instruction on a value computed twice.
//
// Design. The TPU kernel works on full-width [R, W] blocks because its
// vector unit wants 128 lanes. Here a group of G lanes (a power of two, 4 to
// 32; the wrapper's requantize_geometry picks it) takes one row, 32 / G rows
// a warp. The row's q columns go in words of 4: word w to lane w % G, which
// loads its 4 q bytes as one 32-bit word and its 4 grads as one float4 and
// keeps the updated values in registers from the absmax to the rounding
// (WPL words a lane; G is the number of q words rounded up to a power of
// two, so at e = 16 four lanes take a row and each computes 4 columns).
// scale and acc are 32-bit loads that every lane of the group makes (one
// transaction). The sum of g^2 runs from column 0 up, in order, as the
// plain version sums it: word by word, the owner of word w adds its 4
// squares to the running sum and hands it to the group with a shuffle. The
// absmax is a __shfl_xor_sync tree. Every operation rounds as torch rounds
// it (__fmul_rn and friends: nvcc would otherwise contract q * scale - x
// into an FMA), so the rows agree with the plain version's bit for bit.
// Stores: where W is a multiple of 16 every lane writes whole 16-byte units
// (UNIT = 16): the 4 q words of unit k are gathered with 4 shuffles to
// lane 4k % G, and the units past the q bytes (scale', acc' and zeros) go
// round-robin over the group. Where W is only a multiple of 4 the lanes
// write 32-bit words (UNIT = 4). No shared memory. The grid is the number
// of blocks the card holds at once (occupancy times SMs), each looping over
// tiles of THREADS / G rows, so no block waits for a second wave.

#include <cuda_runtime.h>
#include <stdint.h>

#include "id_hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_WIDTH = 4096;  // bytes a row
constexpr unsigned FULL = 0xffffffffu;

// 4 little-endian bytes at any alignment.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) | ((uint32_t)__ldg(p + 2) << 16) |
         ((uint32_t)__ldg(p + 3) << 24);
}

// Word wi (bytes 4 wi .. 4 wi + 3) of a new row: the q' bytes `q` below
// column e, then scale' and acc' bits, zeros from byte e + 8 on.
__device__ __forceinline__ uint32_t row_word(int wi, uint32_t q, uint32_t sbits, uint32_t abits,
                                             int e) {
  const int c0 = 4 * wi;
  if (c0 + 4 <= e) return q;
  if (c0 >= e + 8) return 0u;
  if (c0 == e) return sbits;
  if (c0 == e + 4) return abits;
  uint32_t out = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int c = c0 + b;
    uint32_t byte = 0u;
    if (c < e) {
      byte = (q >> (8 * b)) & 0xffu;
    } else if (c < e + 4) {
      byte = (sbits >> (8 * (c - e))) & 0xffu;
    } else if (c < e + 8) {
      byte = (abits >> (8 * (c - e - 4))) & 0xffu;
    }
    out |= byte << (8 * b);
  }
  return out;
}

template <int G, int WPL, int UNIT>
__global__ void __launch_bounds__(THREADS)
requantize_rows_kernel(const uint8_t* __restrict__ moved, const float* __restrict__ g,
                       const int* __restrict__ ids, uint8_t* __restrict__ out, long long n,
                       int w, int e, const uint32_t* __restrict__ salt_word, float lr,
                       float eps) {
  constexpr int ROWS = THREADS / G;  // rows a block takes at once
  const uint32_t salt = __ldg(salt_word);
  const int glane = threadIdx.x & (G - 1);
  const int nqw = (e + 3) >> 2;  // q words a row
  const bool words_aligned = (e & 3) == 0;
  const bool g_vec = words_aligned && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const long long tiles = (n + ROWS - 1) / ROWS;
  // every lane runs every iteration (the loop bound is the block's), so the
  // group's shuffles always find all 32 lanes; rows past n only skip memory
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row = tile * ROWS + threadIdx.x / G;
    const bool valid = row < n;
    const uint8_t* src = moved + row * w;
    const float* grow = g + row * e;

    float scale = 0.f, acc = 0.f;
    uint32_t id = 0u;
    float val[WPL][4];  // the grads, then the updated row
    uint32_t qin[WPL];
#pragma unroll
    for (int s = 0; s < WPL; ++s) {
      qin[s] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) val[s][i] = 0.f;
    }
    if (valid) {
      if (words_aligned) {
        scale = __uint_as_float(__ldg(reinterpret_cast<const uint32_t*>(src + e)));
        acc = __uint_as_float(__ldg(reinterpret_cast<const uint32_t*>(src + e + 4)));
      } else {
        scale = __uint_as_float(load_word(src + e));
        acc = __uint_as_float(load_word(src + e + 4));
      }
      id = (uint32_t)__ldg(ids + row);
#pragma unroll
      for (int s = 0; s < WPL; ++s) {
        const int wi = s * G + glane;
        if (wi < nqw) {
          qin[s] = __ldg(reinterpret_cast<const uint32_t*>(src) + wi);
          if (g_vec) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(grow) + wi);
            val[s][0] = v.x;
            val[s][1] = v.y;
            val[s][2] = v.z;
            val[s][3] = v.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              val[s][i] = 4 * wi + i < e ? __ldg(grow + 4 * wi + i) : 0.f;
          }
        }
      }
    }

    // sum of g^2 from column 0 up, in order: word by word, the word's lane
    // adds its squares to the running sum and shuffles it to the group
    float ss = 0.f;
#pragma unroll
    for (int s = 0; s < WPL; ++s) {
      for (int o = 0; o < G && s * G + o < nqw; ++o) {
        float t = ss;
        if (glane == o) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * (s * G + o) + i < e) t = __fadd_rn(t, __fmul_rn(val[s][i], val[s][i]));
        }
        ss = __shfl_sync(FULL, t, o, G);
      }
    }
    const float acc_new = __fadd_rn(acc, __fdiv_rn(ss, (float)e));
    const float denom = __fadd_rn(__fsqrt_rn(acc_new), eps);

    float absmax = 0.f;
#pragma unroll
    for (int s = 0; s < WPL; ++s) {
      const int wi = s * G + glane;
      if (wi < nqw) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float current = __fmul_rn((float)(int8_t)(qin[s] >> (8 * i)), scale);
          val[s][i] = __fsub_rn(current, __fdiv_rn(__fmul_rn(lr, val[s][i]), denom));
          if (4 * wi + i < e) absmax = fmaxf(absmax, fabsf(val[s][i]));
        }
      }
    }
#pragma unroll
    for (int off = G / 2; off; off >>= 1)
      absmax = fmaxf(absmax, __shfl_xor_sync(FULL, absmax, off, G));
    const float scale_new = absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;

    const uint32_t key = id_key(id);
    uint32_t qout[WPL];
#pragma unroll
    for (int s = 0; s < WPL; ++s) {
      const int wi = s * G + glane;
      qout[s] = 0u;
      if (wi < nqw) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t bits = id_keyed_bits(key, (uint32_t)(4 * wi + i), salt);
          const float u = (float)(bits >> 8) * (1.f / 16777216.f);  // exact: 24 bits, power of 2
          float q = floorf(__fadd_rn(__fdiv_rn(val[s][i], scale_new), u));
          q = fminf(fmaxf(q, -127.f), 127.f);
          qout[s] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * i);
        }
      }
    }

    const uint32_t sbits = __float_as_uint(scale_new), abits = __float_as_uint(acc_new);
    uint8_t* dst = out + row * w;
    if constexpr (UNIT == 16) {
      // unit k = s * (G / 4) + m holds words s * G + 4m .. + 3, lanes 4m ..
      // 4m + 3 of slot s: lane 4m gathers them and stores the unit
      const int nqu = (e + 15) >> 4;  // units with q bytes
#pragma unroll
      for (int s = 0; s < WPL; ++s) {
        if (s * G >= nqw) break;
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __shfl_sync(FULL, qout[s], (glane & ~3) + i, G);
        const int k = s * (G / 4) + (glane >> 2);
        if (valid && (glane & 3) == 0 && k < nqu) {
          reinterpret_cast<uint4*>(dst)[k] =
              make_uint4(row_word(4 * k, v[0], sbits, abits, e),
                         row_word(4 * k + 1, v[1], sbits, abits, e),
                         row_word(4 * k + 2, v[2], sbits, abits, e),
                         row_word(4 * k + 3, v[3], sbits, abits, e));
        }
      }
      if (valid) {
        for (int k = nqu + glane; k < w / 16; k += G) {
          reinterpret_cast<uint4*>(dst)[k] =
              16 * k >= e + 8 ? make_uint4(0u, 0u, 0u, 0u)
                              : make_uint4(row_word(4 * k, 0u, sbits, abits, e),
                                           row_word(4 * k + 1, 0u, sbits, abits, e),
                                           row_word(4 * k + 2, 0u, sbits, abits, e),
                                           row_word(4 * k + 3, 0u, sbits, abits, e));
        }
      }
    } else if (valid) {
      uint32_t* dst_words = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
      for (int s = 0; s < WPL; ++s) {
        const int wi = s * G + glane;
        if (wi < nqw) dst_words[wi] = row_word(wi, qout[s], sbits, abits, e);
      }
      for (int wi = nqw + glane; wi < w / 4; wi += G)
        dst_words[wi] = row_word(wi, 0u, sbits, abits, e);
    }
  }
}

// The instances the wrapper's geometry names: (lanes a row, q words a lane).
#define REQUANTIZE_INSTANCES(X) X(4, 1) X(8, 1) X(16, 1) X(32, 1) X(32, 4)

// Blocks of one instance a SM can hold, found once (-1 on an error).
template <int G, int WPL, int UNIT>
int blocks_per_sm() {
  static const int blocks = [] {
    int b = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &b, requantize_rows_kernel<G, WPL, UNIT>, THREADS, 0) == cudaSuccess ? b : -1;
  }();
  return blocks;
}

template <int G, int WPL, int UNIT>
int registers() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, requantize_rows_kernel<G, WPL, UNIT>) != cudaSuccess) return -1;
  return attr.numRegs;
}

// The instance's blocks a SM (or registers a thread); -2 for an instance
// that is not built.
int instance_query(int group, int words, int unit, bool regs) {
#define QUERY(G_, W_)                                                                    \
  if (group == G_ && words == W_) {                                                      \
    if (unit == 16) return regs ? registers<G_, W_, 16>() : blocks_per_sm<G_, W_, 16>(); \
    if (unit == 4) return regs ? registers<G_, W_, 4>() : blocks_per_sm<G_, W_, 4>();    \
  }
  REQUANTIZE_INSTANCES(QUERY)
#undef QUERY
  return -2;
}

// Blocks of the grid: what the card holds at once, at most one a tile.
long long grid_blocks(long long n, int group, int words, int unit) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const int per_sm = instance_query(group, words, unit, false);
  if (per_sm < 1) return -1;
  const long long tiles = (n + THREADS / group - 1) / (THREADS / group);
  const long long resident = (long long)per_sm * sms;
  return tiles < resident ? tiles : resident;
}

}  // namespace

extern "C" {

// moved [n, w] u8 (w % 4 == 0, 4-byte aligned), g [n, e] f32, ids [n] int32,
// out [n, w] u8 (16-byte aligned where unit == 16), all contiguous;
// e + 8 <= w <= MAX_WIDTH; group lanes a row and words q words a lane, an
// instance of REQUANTIZE_INSTANCES with group * words * 4 >= e; unit 16
// (w % 16 == 0) or 4; salt one uint32 word on the device. Launch on
// `stream`; returns the cudaError_t (0 = success).
int requantize_rows_launch(const void* moved, const void* g, const void* ids, void* out,
                           long long n, int w, int e, const void* salt, float lr, float eps,
                           int group, int words, int unit, void* stream) {
  if (n < 0 || e < 1 || w % 4 || e + 8 > w || w > MAX_WIDTH || group * words * 4 < e ||
      salt == nullptr || reinterpret_cast<uintptr_t>(salt) % 4 ||
      (unit != 16 && unit != 4) ||
      (unit == 16 && (w % 16 || reinterpret_cast<uintptr_t>(out) % 16)) ||
      reinterpret_cast<uintptr_t>(moved) % 4 || instance_query(group, words, unit, false) == -2)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = grid_blocks(n, group, words, unit);
  if (blocks < 1 || blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  const auto* m = static_cast<const uint8_t*>(moved);
  const auto* gg = static_cast<const float*>(g);
  const auto* ii = static_cast<const int*>(ids);
  auto* o = static_cast<uint8_t*>(out);
  const auto* word = static_cast<const uint32_t*>(salt);
  const auto s = (cudaStream_t)stream;
#define LAUNCH(G_, W_)                                                                          \
  if (group == G_ && words == W_) {                                                             \
    if (unit == 16)                                                                             \
      requantize_rows_kernel<G_, W_, 16><<<(unsigned)blocks, THREADS, 0, s>>>(m, gg, ii, o, n, w, \
                                                                              e, word, lr, eps); \
    else                                                                                        \
      requantize_rows_kernel<G_, W_, 4><<<(unsigned)blocks, THREADS, 0, s>>>(m, gg, ii, o, n, w,  \
                                                                             e, word, lr, eps);  \
    return (int)cudaGetLastError();                                                             \
  }
  REQUANTIZE_INSTANCES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The grid a launch takes (blocks), or -1 where the instance is not built.
long long requantize_grid(long long n, int group, int words, int unit) {
  return grid_blocks(n, group, words, unit);
}

// Registers a thread of the instance, or a negative number where it is not built.
int requantize_registers(int group, int words, int unit) {
  return instance_query(group, words, unit, true);
}

int requantize_max_width() { return MAX_WIDTH; }

int requantize_threads() { return THREADS; }

const char* requantize_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
