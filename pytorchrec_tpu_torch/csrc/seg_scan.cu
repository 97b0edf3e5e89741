// Segmented inclusive sum scan for Hopper (sm_90a), f32.
//
// Replaces pytorchrec_tpu/ops/kernels/seg_scan.py::_seg_scan_kernel (the
// pl.pallas_call in segmented_sum_scan_pallas). For x [n, E] rows in
// id-sorted order (row r at x + r * ld, E contiguous floats) and is_start [n]
// marking segment heads it writes out [n, E], contiguous, with the running
// sum of each segment: out[r] = x[r] at a head, out[r-1] + x[r] elsewhere.
// Each segment's last row holds its total.
//
// Bound: each input byte read once, each output byte written once:
// (2 * n * E * 4 + n) bytes, 110 MB at the packed update's shape
// (n = 851,968, E = 16): 0.033 ms at 3.35 TB/s. n * E additions are nothing
// beside that, so the kernel is bound by bytes.
//
// Design. The TPU kernel walks its grid in order and carries the open
// segment's sum from one block to the next in VMEM. Hopper blocks run in
// parallel and in no order, so the carry takes three launches:
//   1. seg_scan_tiles: each block copies a tile of R rows (R * E <= 8192
//      floats, 32 KB) into shared memory with coalesced loads, scans it with
//      carry-in 0 and writes it out. Inside the tile, the thread of column c
//      in group g walks a run of R / G consecutive rows (G = 256 / E groups),
//      then one thread a column walks the G group sums in order and hands
//      each group the sum open at its start, which that group adds to its
//      rows before its first head. The block writes its tile's last row (its
//      aggregate), whether the tile holds a head, and how many rows precede
//      its first head.
//   2. seg_scan_carries: one block scans the aggregates with the segmented
//      operator (a, fa) + (b, fb) = (fb ? b : a + b, fa | fb), tile by tile
//      with a running carry, in place. Aggregate t then holds the true running
//      sum at the last row of tile t.
//   3. seg_scan_fixup: tile t > 0 adds aggregate t - 1 to its rows before its
//      first head. Most tiles start with a head or a short run, so this pass
//      touches few bytes; a segment longer than a tile is fixed in full.
// Sums run in another order than the Hillis-Steele passes of the plain
// version (sequentially within a run), so results agree to f32 rounding.
// A single-pass decoupled look-back scan is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // also the widest E: one thread a column at least
constexpr int TILE_FLOATS = 8192;  // 32 KB of shared memory a tile
constexpr int MAX_ROWS = 1024;

// Rows a tile holds at width e: the largest power of two <= TILE_FLOATS / e,
// at most MAX_ROWS.
__host__ __device__ inline int tile_rows(int e) {
  int r = MAX_ROWS;
  while (r > 1 && r * e > TILE_FLOATS) r >>= 1;
  return r;
}

struct Shared {
  float tile[TILE_FLOATS];  // row r, column c at tile[r * e + c]
  uint8_t head[MAX_ROWS];
  float group_sum[THREADS];  // [G][e]: a group's sum, then the sum open at its start
  int group_head[THREADS];   // [G]: a group's first head, -1 if none
  float carry[THREADS];      // [e]: sum open at the tile's start, then at its end
  int lead;                  // rows of the tile before its first head
};

// Scans rows [0, rows) of s.tile in place. On entry s.carry[c] holds the sum
// of the segment open at the tile's start; on return it holds the running
// sum at the tile's last row, and s.lead the rows before the first head.
// Every thread of the block calls it; it ends with a barrier.
__device__ void scan_tile(Shared& s, int rows, int e) {
  const int tid = threadIdx.x;
  const int groups = THREADS / e;
  const int run = (rows + groups - 1) / groups;
  const int c = tid % e, g = tid / e;
  const int r0 = g * run, r1 = min(rows, r0 + run);
  if (g < groups) {
    float acc = 0.f;
    int first = -1;
    for (int r = r0; r < r1; ++r) {
      if (s.head[r]) {
        acc = 0.f;
        if (first < 0) first = r;
      }
      acc += s.tile[r * e + c];
      s.tile[r * e + c] = acc;
    }
    s.group_sum[g * e + c] = acc;
    if (c == 0) s.group_head[g] = first;
  }
  __syncthreads();
  if (tid < e) {  // the groups' carries, in row order
    float carry = s.carry[c];
    int lead = rows;
    for (int k = 0; k < groups; ++k) {
      const float sum = s.group_sum[k * e + c];
      s.group_sum[k * e + c] = carry;
      const int head = s.group_head[k];
      carry = head >= 0 ? sum : carry + sum;
      if (head >= 0 && lead == rows) lead = head;
    }
    s.carry[c] = carry;
    if (c == 0) s.lead = lead;
  }
  __syncthreads();
  if (g < groups) {
    const int stop = s.group_head[g] >= 0 ? s.group_head[g] : r1;
    const float carry = s.group_sum[g * e + c];
    for (int r = r0; r < stop; ++r) s.tile[r * e + c] += carry;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
seg_scan_tiles(const float* __restrict__ x, long long ld, const uint8_t* __restrict__ is_start,
               float* __restrict__ out, int n, int e, float* __restrict__ agg,
               uint8_t* __restrict__ agg_head, int* __restrict__ lead) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int big_r = tile_rows(e);
  const long long row0 = (long long)blockIdx.x * big_r;
  const int rows = (int)min((long long)big_r, n - row0);
  for (int i = tid; i < rows * e; i += THREADS) {
    const int r = i / e, c = i - r * e;
    s.tile[i] = __ldg(x + (row0 + r) * ld + c);
  }
  for (int r = tid; r < rows; r += THREADS) s.head[r] = __ldg(is_start + row0 + r);
  if (tid < e) s.carry[tid] = 0.f;
  __syncthreads();
  scan_tile(s, rows, e);
  float* o = out + row0 * e;
  for (int i = tid; i < rows * e; i += THREADS) o[i] = s.tile[i];
  if (tid < e) agg[(long long)blockIdx.x * e + tid] = s.carry[tid];
  if (tid == 0) {
    agg_head[blockIdx.x] = s.lead < rows;
    lead[blockIdx.x] = s.lead;
  }
}

// One block: inclusive segmented scan of the tiles' aggregates, in place.
__global__ void __launch_bounds__(THREADS)
seg_scan_carries(float* __restrict__ agg, const uint8_t* __restrict__ agg_head, int tiles, int e) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int big_r = tile_rows(e);
  if (tid < e) s.carry[tid] = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += big_r) {
    const int rows = min(big_r, tiles - t0);
    float* a = agg + (long long)t0 * e;
    for (int i = tid; i < rows * e; i += THREADS) s.tile[i] = a[i];
    for (int r = tid; r < rows; r += THREADS) s.head[r] = agg_head[t0 + r];
    __syncthreads();
    scan_tile(s, rows, e);  // carries s.carry on to the next chunk
    for (int i = tid; i < rows * e; i += THREADS) a[i] = s.tile[i];
    __syncthreads();
  }
}

// Tile blockIdx.x + 1 adds the running sum at the end of the tile before it
// to its rows before its first head.
__global__ void __launch_bounds__(THREADS)
seg_scan_fixup(float* __restrict__ out, const float* __restrict__ agg,
               const int* __restrict__ lead, int e) {
  const int t = blockIdx.x + 1;
  const int rows = __ldg(lead + t);
  if (rows == 0) return;
  const float* carry = agg + (long long)(t - 1) * e;
  float* o = out + (long long)t * tile_rows(e) * e;
  for (int i = threadIdx.x; i < rows * e; i += THREADS) o[i] += __ldg(carry + i % e);
}

}  // namespace

extern "C" {

// The widest E the kernel takes (the wrapper raises beyond it).
int seg_scan_max_width() { return THREADS; }

// Rows a tile holds at width e: the wrapper sizes the scratch arrays
// (ceil(n / rows) aggregates) with it.
int seg_scan_tile_rows(int e) { return tile_rows(e); }

// Launch the three passes on `stream`; returns the cudaError_t of the
// launches (0 = success). agg [tiles, e] f32, agg_head [tiles] u8 and
// lead [tiles] i32 are scratch, tiles = ceil(n / seg_scan_tile_rows(e)).
int segmented_sum_scan_f32(const float* x, long long ld, const uint8_t* is_start, float* out,
                           int n, int e, float* agg, uint8_t* agg_head, int* lead,
                           void* stream) {
  if (n < 1 || e < 1 || e > THREADS || ld < e) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)((n + (long long)tile_rows(e) - 1) / tile_rows(e));
  seg_scan_tiles<<<tiles, THREADS, 0, s>>>(x, ld, is_start, out, n, e, agg, agg_head, lead);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  seg_scan_carries<<<1, THREADS, 0, s>>>(agg, agg_head, tiles, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_scan_fixup<<<tiles - 1, THREADS, 0, s>>>(out, agg, lead, e);
  return (int)cudaGetLastError();
}

const char* seg_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
