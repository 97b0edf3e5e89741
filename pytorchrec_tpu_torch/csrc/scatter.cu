// Row scatter-set for Hopper (sm_90a): table[ids[i]] = rows[i], in place.
//
// Replaces pytorchrec_tpu/ops/kernels/dma_scatter.py::_scatter_kernel (the
// pl.pallas_call in dma_scatter_set), which computes
// table.at[ids].set(rows, mode='drop', unique_indices=True): a slot whose id
// lies outside [0, V) is dropped, and the ids that survive are unique, so no
// two slots write one row and no atomics are needed.
//
// Bound: the surviving rows read once and written once, plus the ids:
// (2 * kept * row_bytes + 4 * n) bytes. At the packed update's shape (852k
// slots, about 726k of them surviving, 256-byte rows) that is 375 MB:
// 0.112 ms at 3.35 TB/s. Nothing is computed, so the kernel is bound by bytes.
//
// Design. The TPU kernel keeps up to 16 row DMAs in flight through a ring of
// semaphores. Here the parallelism is the card's: 16 threads copy one row,
// 16 bytes a thread (a 256-byte row is one load and one store a thread), 16
// rows a block of 256 threads, and the grid covers every slot, so tens of
// thousands of rows are in flight. A dropped slot costs only its id read.
// Rows whose width or address is not a multiple of 16 bytes copy 4 bytes
// (or 1 byte) a step instead; the unit is chosen once a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 16;                 // threads that copy one row
constexpr int SLOTS = THREADS / LANES;    // rows a block

template <typename U>
__global__ void __launch_bounds__(THREADS)
scatter_rows(U* __restrict__ table, const U* __restrict__ rows, const int* __restrict__ ids,
             long long n, long long v, long long units) {
  const long long slot = (long long)blockIdx.x * SLOTS + threadIdx.x / LANES;
  if (slot >= n) return;
  const int id = __ldg(ids + slot);
  if (id < 0 || id >= v) return;
  const U* src = rows + slot * units;
  U* dst = table + (long long)id * units;
  for (long long u = threadIdx.x % LANES; u < units; u += LANES) dst[u] = __ldg(src + u);
}

template <typename U>
cudaError_t launch(void* table, const void* rows, const int* ids, long long n, long long v,
                   long long row_bytes, cudaStream_t stream) {
  const long long blocks = (n + SLOTS - 1) / SLOTS;
  scatter_rows<U><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<U*>(table), static_cast<const U*>(rows), ids, n, v,
      row_bytes / (long long)sizeof(U));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table [v, row_bytes] and rows [n, row_bytes] as bytes, both contiguous;
// ids [n] int32. Launch on `stream`; returns the cudaError_t (0 = success).
int scatter_set_rows_launch(void* table, const void* rows, const int* ids, long long n,
                            long long v, long long row_bytes, void* stream) {
  if (n < 0 || v < 0 || row_bytes < 1 || (n + SLOTS - 1) / SLOTS >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(rows);
  if (row_bytes % 16 == 0 && addresses % 16 == 0)
    return (int)launch<uint4>(table, rows, ids, n, v, row_bytes, s);
  if (row_bytes % 4 == 0 && addresses % 4 == 0)
    return (int)launch<uint32_t>(table, rows, ids, n, v, row_bytes, s);
  return (int)launch<uint8_t>(table, rows, ids, n, v, row_bytes, s);
}

const char* scatter_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
