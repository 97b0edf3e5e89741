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
// parallel and in no order; here one launch carries the sum across tiles
// with a look-back after Merrill and Garland ("Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016), over aggregates only, with the
// segmented operator (a, fa) + (b, fb) = (fb ? b : a + b, fa | fb):
//   1. A block takes a tile number from an atomic ticket, not from
//      blockIdx: every tile before it belongs to a block that started
//      earlier, so its waits always end.
//   2. It copies its tile of R rows (R * E <= 8192 floats, 32 KB of dynamic
//      shared memory: 4 KB at E=1, so more blocks fit an SM) into shared
//      memory once, with loads of V floats (V = 4, 2 or 1: the widest the
//      slice's address and row stride allow; the int8 update's slice starts
//      24 bytes into a 128-byte row, so V = 2 there), up to 8 loads a thread
//      in flight at once.
//   3. It scans the tile with carry-in 0: the thread of column c in group g
//      walks a run of R / G consecutive rows (G = 256 / E groups), then the
//      G group sums of each column are scanned in shared memory (log2 G
//      Hillis-Steele steps) and each group adds the sum open at its start
//      to its rows before its first head.
//   4. It publishes, for each column, its tile's status in one 64-bit word
//      written by one store, so a reader never sees a state without its
//      value: the aggregate as a double, its two lowest mantissa bits (2^-51
//      of it) replaced by the state, HEAD where the tile holds a head (and at
//      tile 0: the segment open at its end starts inside it), else
//      AGGREGATE. A tile publishes nothing else: no inclusive prefix.
//   5. It looks back over aggregates only: column c adds its predecessors'
//      aggregates in double, nearest first, down to the nearest tile that
//      holds a head, whose aggregate is its own prefix. The first round reads
//      one predecessor (the common case: it holds a head); later rounds read
//      LOOK a group, 256 / E groups at once, each group summing its
//      predecessors nearest first, then column c adding the groups' sums in
//      order. Which words are summed, and in what order, depends on t, E and
//      the heads alone, never on timing, so every run gives the same bits.
//      The price: a segment that crosses k tiles has each of them read up
//      to k status words a column (one segment over all n rows: k = n / R).
//   6. It writes the tile once, adding the carry to its rows before its
//      first head (in double, rounded once to f32).
// The ticket and the status words are zeroed by one cudaMemsetAsync on the
// stream before the launches (also under a CUDA graph's capture). Any E: one
// launch for each chunk of at most 256 columns (one thread a column at
// least), each chunk with a ticket and status words of its own, writing its
// columns of the [n, E] output at row stride E.
// Sums run in another order than the Hillis-Steele passes of the plain
// version (sequentially within a run, then by groups; across tiles in
// double), so results agree to f32 rounding; the order is fixed, so the
// kernel's own bits repeat from run to run, as the three-pass design's did.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // also the widest chunk: one thread a column at least
constexpr int TILE_FLOATS = 8192;  // 32 KB of dynamic shared memory a tile at most
constexpr int MAX_ROWS = 1024;
constexpr int BATCH = 8;  // loads a thread keeps in flight at once
constexpr int HEADS = MAX_ROWS / THREADS;  // head flags a thread loads
constexpr int LOOK = 8;  // predecessors a look-back group reads in one round
// status states, in the two low mantissa bits of the published double
constexpr unsigned long long AGGREGATE = 1, HEAD = 2, STATE = 3;

// Rows a tile holds at width e: the largest power of two <= TILE_FLOATS / e,
// at most MAX_ROWS.
__host__ __device__ inline int tile_rows(int e) {
  int r = MAX_ROWS;
  while (r > 1 && r * e > TILE_FLOATS) r >>= 1;
  return r;
}

// Shared memory beside the tile, which is dynamic: tile_rows(w) * w floats.
struct Shared {
  float part[THREADS];                 // [G][w]: a group's sum, then the scan's
  int part_head[THREADS];              // [G][w]: the group holds a head
  double look[THREADS];                // [G][w]: a look-back group's sum
  int look_head[THREADS];              // [G][w]: the group met a HEAD
  double carry[THREADS];               // [w]: the sum open at the tile's start
  uint8_t head[MAX_ROWS];
  int lead;                            // rows of the tile before its first head
  int tile_id;
};

// A status word: the double v with its two low mantissa bits (2^-51 of it,
// far below f32's precision) replaced by the state; 0 is "not yet".
__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long state,
                                        double v) {
  const unsigned long long word = ((unsigned long long)__double_as_longlong(v) & ~STATE) | state;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word) : "memory");
}

__device__ __forceinline__ unsigned long long read_status(const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(word) : "l"(p) : "memory");
  return word;
}

__device__ __forceinline__ double status_value(unsigned long long word) {
  return __longlong_as_double((long long)(word & ~STATE));
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int V>
__global__ void __launch_bounds__(THREADS)
seg_scan_lookback(const float* __restrict__ x, long long ld, const uint8_t* __restrict__ is_start,
                  float* __restrict__ out, long long ldo, int n, int w,
                  unsigned int* __restrict__ ticket, unsigned long long* __restrict__ status) {
  using T = typename Vec<V>::T;
  extern __shared__ float4 dynamic[];
  float* tile = reinterpret_cast<float*>(dynamic);  // row r, column c at tile[r * w + c]
  T* tile_v = reinterpret_cast<T*>(dynamic);
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int big_r = tile_rows(w);
  if (tid == 0) {
    s.tile_id = (int)atomicAdd(ticket, 1u);
    s.lead = MAX_ROWS;
  }
  __syncthreads();
  const int t = s.tile_id;
  const long long row0 = (long long)t * big_r;
  const int rows = (int)min((long long)big_r, n - row0);

  // 2. the tile, once, V floats a load, BATCH loads in flight a thread
  uint8_t h[HEADS];
#pragma unroll
  for (int k = 0; k < HEADS; ++k) {
    const int r = tid + k * THREADS;
    h[k] = r < rows ? __ldg(is_start + row0 + r) : 0;
  }
  const int vpr = w / V;  // vectors a row
  const int total = rows * vpr;
  for (int i0 = tid; i0 < total; i0 += THREADS * BATCH) {
    T v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * THREADS;
      if (i < total) {
        const int r = i / vpr, cv = i - r * vpr;
        v[k] = __ldg(reinterpret_cast<const T*>(x + (row0 + r) * ld) + cv);
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * THREADS;
      if (i < total) tile_v[i] = v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < HEADS; ++k) {
    const int r = tid + k * THREADS;
    if (r < rows) s.head[r] = h[k];
  }
  __syncthreads();

  // 3. scan with carry-in 0: runs, then the groups' sums, then the runs' carries
  const int groups = THREADS / w;
  const int run = (rows + groups - 1) / groups;
  const int c = tid % w, g = tid / w;
  const bool member = g < groups;
  const int r0 = g * run, r1 = min(rows, r0 + run);
  float acc = 0.f;
  int first = -1;
  if (member) {
    for (int r = r0; r < r1; ++r) {
      if (s.head[r]) {
        acc = 0.f;
        if (first < 0) first = r;
      }
      acc += tile[r * w + c];
      tile[r * w + c] = acc;
    }
    s.part[tid] = acc;
    s.part_head[tid] = first >= 0;
    if (c == 0 && first >= 0) atomicMin(&s.lead, first);
  }
  __syncthreads();
  float sum = acc;
  int flag = first >= 0;
  for (int d = 1; d < groups; d <<= 1) {
    float prev = 0.f;
    int prev_flag = 0;
    if (member && g >= d) {
      prev = s.part[tid - d * w];
      prev_flag = s.part_head[tid - d * w];
    }
    __syncthreads();
    if (member && g >= d) {
      sum = flag ? sum : prev + sum;
      flag |= prev_flag;
      s.part[tid] = sum;
      s.part_head[tid] = flag;
    }
    __syncthreads();
  }
  // s.part[g * w + c] is now the running sum at the end of group g's run
  if (member && g > 0) {
    const float open = s.part[tid - w];
    const int stop = first >= 0 ? first : r1;
    for (int r = r0; r < stop; ++r) tile[r * w + c] += open;
  }
  __syncthreads();
  const int lead = min(s.lead, rows);
  const bool has_head = lead < rows;
  const int last = (groups - 1) * w;  // the last group's entries hold the tile's aggregate

  // 4. publish the aggregate
  unsigned long long* own = status + (long long)t * w;
  if (tid < w) {
    s.carry[tid] = 0.0;
    publish(own + tid, (t == 0 || has_head) ? HEAD : AGGREGATE, (double)s.part[last + tid]);
  }
  __syncthreads();

  // 5. look back over aggregates, in an order fixed by t, w and the heads;
  // summing in double, the carry rounds to f32 once in each row it reaches
  if (t > 0) {
    long long base = t - 1;  // the nearest predecessor not yet read
    int span = 1;            // predecessors a group reads this round
    double carry = 0.0;
    bool done = false;
    while (!done) {
      const int readers = span == 1 ? 1 : groups;
      if (member && g < readers) {
        const long long near = base - (long long)g * span;  // this group's nearest
        unsigned long long word[LOOK];
#pragma unroll
        for (int k = 0; k < LOOK; ++k)
          if (k < span && near - k >= 0) word[k] = read_status(status + (near - k) * w + c);
        double sum = 0.0;
        int closed = 0;
#pragma unroll
        for (int k = 0; k < LOOK; ++k) {
          if (k < span && near - k >= 0 && !closed) {
            while ((word[k] & STATE) == 0) {
              __nanosleep(20);
              word[k] = read_status(status + (near - k) * w + c);
            }
            sum += status_value(word[k]);
            closed = (word[k] & STATE) == HEAD;
          }
        }
        s.look[tid] = sum;
        s.look_head[tid] = closed;
      }
      __syncthreads();
      bool met = false;
      if (tid < w)
        for (int k = 0; k < readers && !met; ++k) {
          carry += s.look[k * w + tid];
          met = s.look_head[k * w + tid];
        }
      // every column of a tile publishes the same state, so all meet a HEAD
      // in the same round (tile 0 at the latest)
      done = __syncthreads_or(met);
      base -= (long long)readers * span;
      span = LOOK;
    }
    if (tid < w) s.carry[tid] = carry;
    __syncthreads();
  }

  // 6. the tile, once, the carry added before its first head
  float* o = out + row0 * ldo;
  for (int i = tid; i < total; i += THREADS) {
    const int r = i / vpr, cv = i - r * vpr;
    T v = tile_v[i];
    if (r < lead) {
      float* f = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = (float)(s.carry[cv * V + k] + (double)f[k]);
    }
    reinterpret_cast<T*>(o + r * ldo)[cv] = v;
  }
}

int tiles_of(int n, int w) { return (int)((n + (long long)tile_rows(w) - 1) / tile_rows(w)); }

// Status words (and the ticket's word) chunk by chunk, for n rows of e columns.
long long scratch_words(int n, int e) {
  long long words = 0;
  for (int c0 = 0; c0 < e; c0 += THREADS) {
    const int w = e - c0 < THREADS ? e - c0 : THREADS;
    words += 1 + (long long)tiles_of(n, w) * w;
  }
  return words;
}

using Kernel = void (*)(const float*, long long, const uint8_t*, float*, long long, int, int,
                        unsigned int*, unsigned long long*);

Kernel instance(int v) {
  if (v == 1) return seg_scan_lookback<1>;
  if (v == 2) return seg_scan_lookback<2>;
  if (v == 4) return seg_scan_lookback<4>;
  return nullptr;
}

}  // namespace

extern "C" {

// The widest chunk of columns one launch scans.
int seg_scan_chunk_width() { return THREADS; }

// Rows a tile holds at width e.
int seg_scan_tile_rows(int e) { return tile_rows(e); }

// 64-bit words of scratch a call over n rows of e columns needs: for each
// chunk of at most THREADS columns, a ticket and one status word a tile and
// column.
long long seg_scan_scratch_words(int n, int e) { return n < 1 || e < 1 ? 0 : scratch_words(n, e); }

// Zero the scratch and launch one look-back scan a chunk of at most THREADS
// columns on `stream`; returns the cudaError_t (0 = success). out is [n, e]
// contiguous; scratch holds seg_scan_scratch_words(n, e) 64-bit words. vec
// (4, 2 or 1) floats a load and a store: e and ld must be multiples of it, x
// and out aligned to 4 * vec bytes.
int segmented_sum_scan_f32(const float* x, long long ld, const uint8_t* is_start, float* out,
                           int n, int e, int vec, void* scratch, void* stream) {
  const Kernel kernel = instance(vec);
  if (n < 1 || e < 1 || ld < e || kernel == nullptr || e % vec || ld % vec ||
      reinterpret_cast<uintptr_t>(x) % (4 * vec) || reinterpret_cast<uintptr_t>(out) % (4 * vec) ||
      reinterpret_cast<uintptr_t>(scratch) % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * scratch_words(n, e), s);
  if (err != cudaSuccess) return (int)err;
  auto* words = static_cast<unsigned long long*>(scratch);
  for (int c0 = 0; c0 < e; c0 += THREADS) {
    const int w = e - c0 < THREADS ? e - c0 : THREADS;
    const int tiles = tiles_of(n, w);
    const size_t smem = sizeof(float) * tile_rows(w) * w;
    kernel<<<tiles, THREADS, smem, s>>>(x + c0, ld, is_start, out + c0, e, n, w,
                                        reinterpret_cast<unsigned int*>(words), words + 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    words += 1 + (long long)tiles * w;
  }
  return (int)cudaSuccess;
}

// Registers a thread and local memory (stack and spills) a thread of the
// instance with vec floats a load; returns the cudaError_t.
int seg_scan_kernel_attributes(int vec, int* registers, int* local_bytes) {
  const Kernel kernel = instance(vec);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaSuccess;
}

const char* seg_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
