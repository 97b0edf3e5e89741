// The id-keyed stochastic-rounding bits, shared by the kernels that round a
// table row (requantize.cu, quantize.cu).
//
// Column c of the row with global id `id` under the per-(table, step) salt
// takes the bits
//   mix_u32((id * 0x9E3779B1 + c * 0x85EBCA77) ^ salt)
// in uint32 arithmetic (products and sums wrap), where mix_u32 is a
// triple32-style finalizer: the bits of
// ops/kernels/quantize.py::id_keyed_rounding_bits, which depend on the row's
// global id and never on its slot or device.

#pragma once

#include <stdint.h>

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

// The row's part of the key, computed once a row.
__device__ __forceinline__ uint32_t id_key(uint32_t id) { return id * 0x9E3779B1u; }

// The bits of column c of the row whose id_key is `key`.
__device__ __forceinline__ uint32_t id_keyed_bits(uint32_t key, uint32_t c, uint32_t salt) {
  return mix_u32((key + c * 0x85EBCA77u) ^ salt);
}
