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
// Narrow rows are bound by sectors, not by their bytes: the row-bytes bound
// counts 4 bytes for a scale or an accumulator and 16 for an int8 row, but
// each row written lands in a 32-byte sector of its own (the kept ids of a
// 2.6M-row table lie about 3.6 rows apart), and memory moves whole sectors.
// Their tables (10 MB at 4-byte rows, 42 MB at 16) fit in the 50 MB L2, so
// a step's scatter writes into L2 and the sector count, the id reads and the
// launch set the pace there.
//
// Design. The TPU kernel keeps up to 16 row DMAs in flight through a ring of
// semaphores. Here the parallelism is the card's, and the lanes given to a
// row match the row (ops/kernels/scatter.py::scatter_plan, which the
// wrapper passes in and this file checks):
// - the unit is the widest load and store (16, 8, 4, 2 or 1 bytes) that
//   divides the row width and both base addresses;
// - a row takes a group of `lanes` threads, the largest power of two up to
//   32 that divides its units, so no lane idles: a 4- or 16-byte row takes
//   one thread, 64 bytes 4, 128 bytes 8, 256 bytes 16, 192 and 384 bytes 4
//   and 8 lanes of 3 units, 1 KB 32 lanes of 2. Only where the units have an
//   odd factor above 4 (13 f32 columns, 7 bytes) do more lanes share the
//   row and the last pass leave some idle;
// - a group copies 4 rows where a lane copies one unit, 2 where up to 4,
//   and 1 beyond (a plain loop); a block is 256 threads, so a 256-thread
//   block of 4- or 16-byte rows covers 1,024 slots. Row r of a group is
//   slot first + r * groups: neighbouring groups (neighbouring lanes, at one
//   lane a row) take neighbouring slots, so the id and row loads of a warp
//   are coalesced and, the ids being sorted at every call site, its stores
//   fall into few sectors;
// - each group loads its ids once, one lane a row, and shuffles them to
//   its lanes; each lane then loads all its units of all its rows into
//   registers before it stores any, so a thread keeps up to 4 rows' loads in
//   flight. A dropped slot costs only its id read.
// Nothing is allocated and nothing synchronises: a launch is capturable in a
// CUDA graph on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LANE_UNITS = 4;  // units a lane holds in registers; more loop

// rows a lane group copies, by the units a lane copies
__host__ __device__ constexpr int rows_a_group(int lane_units) {
  return lane_units == 1 ? 4 : lane_units <= MAX_LANE_UNITS ? 2 : 1;
}

// LANE_UNITS: 1 (one unit a lane), MAX_LANE_UNITS (up to that many, held in
// registers) or 0 (any number, copied in a loop).
template <typename U, int LANES, int LANE_UNITS>
__global__ void __launch_bounds__(THREADS)
scatter_rows(U* __restrict__ table, const U* __restrict__ rows, const int* __restrict__ ids,
             long long n, long long v, int units) {
  constexpr int GROUPS = THREADS / LANES;
  constexpr int ROWS = rows_a_group(LANE_UNITS == 0 ? MAX_LANE_UNITS + 1 : LANE_UNITS);
  constexpr int ID_LOADS = (ROWS + LANES - 1) / LANES;
  const int lane = threadIdx.x % LANES;
  const long long first = (long long)blockIdx.x * (GROUPS * ROWS) + threadIdx.x / LANES;

  // lane l loads the ids of rows l, l + LANES, ...; out of range is -1
  int held[ID_LOADS];
#pragma unroll
  for (int j = 0; j < ID_LOADS; ++j) {
    const int r = lane + j * LANES;
    const long long slot = first + (long long)r * GROUPS;
    held[j] = (r < ROWS && slot < n) ? __ldg(ids + slot) : -1;
  }
  int id[ROWS];
  bool keep[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if constexpr (LANES == 1) {
      id[r] = held[r];
    } else {  // every lane of the warp takes part: no thread has returned
      id[r] = __shfl_sync(0xffffffffu, held[r / LANES], r % LANES, LANES);
    }
    keep[r] = id[r] >= 0 && id[r] < v;
  }

  if constexpr (LANE_UNITS == 0) {
    if (!keep[0]) return;
    const U* src = rows + first * units;
    U* dst = table + (long long)id[0] * units;
    for (int u = lane; u < units; u += LANES) dst[u] = __ldg(src + u);
  } else {
    U value[ROWS][LANE_UNITS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const U* src = rows + (first + (long long)r * GROUPS) * units;
#pragma unroll
      for (int k = 0; k < LANE_UNITS; ++k) {
        const int u = lane + k * LANES;
        if (keep[r] && u < units) value[r][k] = __ldg(src + u);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      U* dst = table + (long long)id[r] * units;
#pragma unroll
      for (int k = 0; k < LANE_UNITS; ++k) {
        const int u = lane + k * LANES;
        if (keep[r] && u < units) dst[u] = value[r][k];
      }
    }
  }
}

template <typename U, int LANES, int LANE_UNITS>
struct Kernel {
  static constexpr long long SLOTS =
      (long long)(THREADS / LANES) * rows_a_group(LANE_UNITS == 0 ? MAX_LANE_UNITS + 1 : LANE_UNITS);
  static const void* address() { return (const void*)scatter_rows<U, LANES, LANE_UNITS>; }
  static cudaError_t launch(void* table, const void* rows, const int* ids, long long n,
                            long long v, int units, cudaStream_t stream) {
    const long long blocks = (n + SLOTS - 1) / SLOTS;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    scatter_rows<U, LANES, LANE_UNITS><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<U*>(table), static_cast<const U*>(rows), ids, n, v, units);
    return cudaGetLastError();
  }
};

// Calls f(Kernel<...>{}) for the plan's instance; cudaErrorInvalidValue for a
// plan that has none.
template <typename U, int LANES, typename F>
cudaError_t with_lane_units(int lane_units, F&& f) {
  if (lane_units == 1) return f(Kernel<U, LANES, 1>{});
  if (lane_units <= MAX_LANE_UNITS) return f(Kernel<U, LANES, MAX_LANE_UNITS>{});
  if constexpr (LANES == 32) return f(Kernel<U, 32, 0>{});
  return cudaErrorInvalidValue;  // the plan loops only at 32 lanes
}

template <typename U, typename F>
cudaError_t with_lanes(int lanes, int lane_units, F&& f) {
  switch (lanes) {
    case 1: return with_lane_units<U, 1>(lane_units, f);
    case 2: return with_lane_units<U, 2>(lane_units, f);
    case 4: return with_lane_units<U, 4>(lane_units, f);
    case 8: return with_lane_units<U, 8>(lane_units, f);
    case 16: return with_lane_units<U, 16>(lane_units, f);
    case 32: return with_lane_units<U, 32>(lane_units, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_plan(int unit, int lanes, int lane_units, F&& f) {
  switch (unit) {
    case 16: return with_lanes<uint4>(lanes, lane_units, f);
    case 8: return with_lanes<uint2>(lanes, lane_units, f);
    case 4: return with_lanes<uint32_t>(lanes, lane_units, f);
    case 2: return with_lanes<uint16_t>(lanes, lane_units, f);
    case 1: return with_lanes<uint8_t>(lanes, lane_units, f);
    default: return cudaErrorInvalidValue;
  }
}

// A plan the kernels can run: the unit divides the row, every unit has a
// lane (lane_units = ceil(units / lanes)) and the rows a group match.
bool plan_fits(long long row_bytes, int unit, int lanes, int lane_units, int group_rows) {
  if (unit < 1 || row_bytes < 1 || row_bytes % unit != 0) return false;
  const long long units = row_bytes / unit;
  if (units >= (1LL << 31) || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return false;
  return lane_units == (units + lanes - 1) / lanes && group_rows == rows_a_group(lane_units);
}

}  // namespace

extern "C" {

// table [v, row_bytes] and rows [n, row_bytes] as bytes, both contiguous;
// ids [n] int32; the plan of ops/kernels/scatter.py::scatter_plan (unit,
// lanes, lane_units, group_rows). Launch on `stream`; returns the
// cudaError_t (0 = success; cudaErrorInvalidValue for a plan that does not
// fit the row or the addresses). n = 0 launches nothing.
int scatter_set_rows_launch(void* table, const void* rows, const int* ids, long long n,
                            long long v, long long row_bytes, int unit, int lanes,
                            int lane_units, int group_rows, void* stream) {
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(rows);
  if (n < 0 || v < 0 || !plan_fits(row_bytes, unit, lanes, lane_units, group_rows) ||
      addresses % unit != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int units = (int)(row_bytes / unit);
  return (int)with_plan(unit, lanes, lane_units, [&](auto kernel) {
    return decltype(kernel)::launch(table, rows, ids, n, v, units, (cudaStream_t)stream);
  });
}

// The registers and local memory (stack and spills) a thread of the plan's
// kernel.
int scatter_kernel_attributes(int unit, int lanes, int lane_units, int* registers,
                              int* local_bytes) {
  cudaFuncAttributes attr{};
  const cudaError_t err = with_plan(unit, lanes, lane_units, [&](auto kernel) {
    return cudaFuncGetAttributes(&attr, decltype(kernel)::address());
  });
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaSuccess;
}

const char* scatter_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
