// Fused retrieval score + bin max for Hopper (sm_90a): bf16 or f32 items.
//
// Replaces pytorchrec_tpu/ops/kernels/retrieval_topk.py::_bin_max_kernel (the
// pl.pallas_call of bin_max_scores_pallas). For queries q [B, D] and a corpus
// items [V, D] of the same type (bf16 or f32), with f32 sums, cut into
// super-chunks of `sup` = tc * group rows (n_super = ceil(V / sup)):
//     vals[b, s * 128 + l] = max over t in [0, sup / 128) of score(b, s * sup + t * 128 + l)
//     idx[b, s * 128 + l]  = the id that scored it, the lowest among equal scores
// where score(b, i) = q_b . items_i for i < V and PAD_SCORE (-1e30) for the
// pad ids i >= V, so a bin with no valid id holds its lowest pad id.
//
// Bound. At the serving shape (4096 queries x 1,000,000 items, D=128) the
// products are 1.049 TFLOP: 1.06 ms on the tensor cores in bf16, 15.65 ms in
// f32 FMA. The bytes (the index read once, 256 MB bf16; the [4096, 3968]
// outputs, 130 MB) take 0.12 ms. So operations bound it; the point of the
// fusion is that the [B, V] score matrix (16 GB in f32) never exists.
//
// The tie rule, in both paths. A thread owns the same (query, bin) pairs in
// every 128-row item tile of a super-chunk (the m16n8 accumulator layout of
// mma.sync and the m64nN layout of wgmma both put element (row g / g + 8,
// column 2c / 2c + 1) of each 8-column slice on the same lane every time). It
// keeps their running max in registers and, where a tile's score is strictly
// larger, the tile number (int32, so any tiles_per_super the int32 ids allow
// fits): in registers in the bf16 path, in the thread's own slots of shared
// memory in the f32 path (where registers ran slower on the H100). Tiles run in ascending
// id order, so a strict > gives the lowest id with no second comparison.
// Tiles wholly past V are not computed: they would put PAD_SCORE in every
// bin, which only a bin whose best is below PAD_SCORE takes, at the first
// such tile; that update runs once.
//
// bf16 path: wgmma fed by TMA, warp-specialised and persistent.
//   * About one block an SM walks the work units (a tile of 128 queries, one
//     super-chunk) in super-chunk-major order, query tile fastest, so the
//     blocks in flight share a few super-chunks (8 MB each) in the L2.
//   * A producer warp keeps a ring of up to 4 item tiles of 128 rows full
//     with TMA (a CUtensorMap over items [V, D], 128-byte swizzle, boxes of 64
//     columns, rows past V zero-filled), completion reported on mbarriers; it
//     loads a unit's query tile once the consumers have released the last.
//   * Two consumer warpgroups each own 64 of the 128 queries and run
//     wgmma.mma_async m64n128k16 with both operands in shared memory (D/16
//     k-steps), then the bin max, with setmaxnreg moving registers from the
//     producer to them. They take turns to issue a tile's product (ping-pong
//     over two named barriers: a little faster on the H100 than issuing freely).
//     The bin max touches registers only: tile numbers stored to shared
//     memory competed with wgmma's operand reads. Its 3 instructions a
//     (query, bin) pair still do not hide under the products (PERF.md), and a
//     second accumulator set does not fit beside the tile numbers.
//   * The depth is cut into 64-column swizzle atoms; columns past D are
//     zero-filled by TMA. TMA needs a row stride that is a multiple of 16
//     bytes, so the wrapper zero-pads D to a multiple of 8 in a scratch copy.
//   * Shared memory: the query tile (128 x D, 32 KB at D=128) and 2 to 4
//     item stages of 128 x D; D <= 256 fits 2 stages.
//
// f32 path: the same pair ownership in a block of one tile of 64 queries and
// one whole super-chunk, its 128-row item tiles streamed through two
// cp.async stages (zero-filled past V), scores as f32 FMA chains in k order,
// as the plain version's cuBLAS sums run. The card's duplicated-rows check
// wants every id equal to plain's; three TF32 tensor-core products (hi/lo
// splits, 9e-7 off plain at the serving shape) flipped near-tied bins there,
// while float64 scores pick plain's id in every bin of it (PERF.md). The
// blocks that share a super-chunk are numbered together, query tile fastest.
//
// Limits (the wrapper checks them before the launch): D <= 256 in bf16 and
// D <= 152 in f32 on the H100 (shared memory); ids are int32, so V and
// n_super * sup must stay below 2^31. Fusing the final top-k is left for
// later work.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;  // bins of a super-chunk = item rows of a tile
constexpr float PAD_SCORE = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma

namespace wg {

constexpr int BM = 128;          // queries a unit: two consumer warpgroups of 64
constexpr int ATOM = 64;         // bf16 columns of one 128-byte swizzle atom
constexpr int ATOM_BYTES = LANES * 128;  // one atom of a 128-row tile: 16 KB
constexpr int CONSUMERS = 256;   // threads of the two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int MAX_STAGES = 4;   // 6 ran no faster on the H100
constexpr int ALIGN = 1024;      // the 128-byte swizzle's atom alignment

__host__ __device__ inline int atoms(int d) { return (d + ATOM - 1) / ATOM; }
__host__ __device__ inline int tile_bytes(int d) { return atoms(d) * ATOM_BYTES; }  // also BM rows
__host__ __device__ inline long long smem_bytes(int d, int stages) {
  return ALIGN + (long long)tile_bytes(d) * (1 + stages) + 8 * (2 * stages + 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a [64 columns, 128 rows] box of a 2-d tensor map at (col, row) into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile under 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties the accumulator to this point of the program: reads after it wait for
// the wgmma_wait before it
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0..63] (+)= A[64 x 16] * B[16 x 128]^T, both bf16 K-major in shared
// memory under 128-byte swizzle; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// named barrier `id` over both consumer warpgroups: sync waits for the other
// warpgroup's arrival, arrive signals it without waiting
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}

template <int KSTEPS>
__global__ void __launch_bounds__(THREADS, 1)
bin_max_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap item_map, float* __restrict__ vals,
                    int* __restrict__ idx, int n_queries, int n_items, int d, int tiles_per_super,
                    int n_query_tiles, int n_super, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const int tb = tile_bytes(d);
  const uint32_t q_smem = smem_addr(base);  // [atoms][128 rows][128 bytes], swizzled
  const uint32_t stage0 = q_smem + tb;      // stages of the same layout
  const uint32_t full0 = stage0 + stages * tb, empty0 = full0 + 8 * stages;
  const uint32_t q_full = empty0 + 8 * stages, q_empty = q_full + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx, then the bytes
      mbar_init(empty0 + 8 * s, 8);  // each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long sup = (long long)tiles_per_super * LANES;
  const int n_units = n_query_tiles * n_super;
  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      const int n_atoms = atoms(d);
      int issued = 0;
      uint32_t q_parity = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int s = u / n_query_tiles, qt = u - s * n_query_tiles;
        const long long s_row0 = s * sup;
        const int tiles =
            (int)min((long long)tiles_per_super, (n_items - s_row0 + LANES - 1) / LANES);
        mbar_wait(q_empty, q_parity ^ 1);  // the consumers are done with the last query tile
        q_parity ^= 1;
        mbar_expect_tx(q_full, tb);
        for (int a = 0; a < n_atoms; ++a)
          tma_load(q_smem + a * ATOM_BYTES, &q_map, a * ATOM, qt * BM, q_full);
        for (int t = 0; t < tiles; ++t, ++issued) {
          const int st = issued % stages;
          mbar_wait(empty0 + 8 * st, ((issued / stages) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * st, tb);
          for (int a = 0; a < n_atoms; ++a)
            tma_load(stage0 + st * tb + a * ATOM_BYTES, &item_map, a * ATOM,
                     (int)(s_row0 + (long long)t * LANES), full0 + 8 * st);
        }
      }
    }
  } else {  // two consumer warpgroups, 64 queries each, in ping-pong
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ctid = threadIdx.x, wgi = ctid >> 7, warp = (ctid >> 5) & 3, lane = ctid & 31;
    const int g = lane >> 2, c = lane & 3;
    const uint32_t a_base = q_smem + wgi * 64 * 128;  // this warpgroup's 64 query rows
    // the warpgroups take turns to issue a tile's product (named barriers
    // 1 + wgi, warpgroup 0 first)
    if (wgi == 1) bar_arrive(1);
    int consumed = 0;
    uint32_t q_parity = 0;
    float acc[64], best[64];
    int best_tile[64];
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int s = u / n_query_tiles, qt = u - s * n_query_tiles;
      const long long s_row0 = s * sup;
      const int tiles =
          (int)min((long long)tiles_per_super, (n_items - s_row0 + LANES - 1) / LANES);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        best[i] = -INFINITY;
        best_tile[i] = 0;
      }
      mbar_wait(q_full, q_parity);
      q_parity ^= 1;
      for (int t = 0; t < tiles; ++t, ++consumed) {
        const int st = consumed % stages;
        mbar_wait(full0 + 8 * st, (consumed / stages) & 1);
        const uint32_t b_base = stage0 + st * tb;
        bar_sync(1 + wgi);  // this warpgroup's turn
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) {
          const uint32_t off = (k >> 2) * ATOM_BYTES + (k & 3) * 32;  // 16 bf16 = 32 bytes
          wgmma_m64n128k16(acc, smem_desc(a_base + off), smem_desc(b_base + off), k > 0);
        }
        wgmma_commit();
        bar_arrive(2 - wgi);  // the other warpgroup's turn
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
        // the bin max: pad ids score PAD_SCORE, and a strictly larger score
        // records the tile number
        const long long row0 = s_row0 + (long long)t * LANES;
        if (row0 + LANES > n_items) {
#pragma unroll
          for (int i = 0; i < 64; ++i)
            if (row0 + 8 * (i >> 2) + 2 * c + (i & 1) >= n_items) acc[i] = PAD_SCORE;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const bool better = acc[i] > best[i];
          best[i] = better ? acc[i] : best[i];
          best_tile[i] = better ? t : best_tile[i];
        }
      }
      if (lane == 0) mbar_arrive(q_empty);  // every product of this unit is done

      // the wholly pad tiles: the first of them puts PAD_SCORE where it is larger
      const bool pad_tiles = tiles < tiles_per_super;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qt * BM + wgi * 64 + warp * 16 + g + 8 * h;
        if (q >= n_queries) continue;
        const long long out_row = ((long long)q * n_super + s) * LANES;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int bin = 8 * j + 2 * c;
          float v[2];
          int id[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            v[e] = best[i];
            int tile = best_tile[i];
            if (pad_tiles && PAD_SCORE > v[e]) {
              v[e] = PAD_SCORE;
              tile = tiles;
            }
            id[e] = (int)(s_row0 + (long long)tile * LANES + bin + e);
          }
          *reinterpret_cast<float2*>(vals + out_row + bin) = make_float2(v[0], v[1]);
          *reinterpret_cast<int2*>(idx + out_row + bin) = make_int2(id[0], id[1]);
        }
      }
    }
    if (wgi == 0) bar_sync(1);  // the last arrival of warpgroup 1, unanswered
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 [rows, d] row-major matrix, read in [128 rows, 64 columns] boxes
// under 128-byte swizzle; rows and columns past the matrix read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {ATOM, LANES};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* queries, const void* items, float* vals, int* idx, int n_queries,
           int n_items, int d, int tiles_per_super, int n_super, cudaStream_t stream) {
  if (d % 8 != 0 || reinterpret_cast<uintptr_t>(queries) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(items) % 16 != 0)
    return (int)cudaErrorInvalidValue;  // TMA's row stride and base alignment
  int device = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int stages = MAX_STAGES;
  while (stages > 2 && smem_bytes(d, stages) > optin) --stages;
  const long long smem = smem_bytes(d, stages);
  if (smem > optin) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, item_map;
  if (!make_map(&q_map, queries, n_queries, d) || !make_map(&item_map, items, n_items, d))
    return (int)cudaErrorInvalidValue;
  const int n_query_tiles = (n_queries + BM - 1) / BM;
  const long long units = (long long)n_query_tiles * n_super;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)(units < sms ? units : sms);
  switch ((d + 15) / 16) {  // k-steps of 16: 1..16 for D <= 256
#define B7_KSTEPS(K)                                                                          \
  case K:                                                                                     \
    err = cudaFuncSetAttribute(bin_max_bf16_kernel<K>,                                        \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);       \
    if (err != cudaSuccess) return (int)err;                                                  \
    bin_max_bf16_kernel<K><<<grid, THREADS, (size_t)smem, stream>>>(                          \
        q_map, item_map, vals, idx, n_queries, n_items, d, tiles_per_super, n_query_tiles,    \
        n_super, stages);                                                                     \
    break;
    B7_KSTEPS(1) B7_KSTEPS(2) B7_KSTEPS(3) B7_KSTEPS(4) B7_KSTEPS(5) B7_KSTEPS(6)
    B7_KSTEPS(7) B7_KSTEPS(8) B7_KSTEPS(9) B7_KSTEPS(10) B7_KSTEPS(11) B7_KSTEPS(12)
    B7_KSTEPS(13) B7_KSTEPS(14) B7_KSTEPS(15) B7_KSTEPS(16)
#undef B7_KSTEPS
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: f32 FMA in the order of the plain version's sums

namespace f32 {

constexpr int BM = 64;                          // queries a block
constexpr int WARPS_N = LANES / 32;
constexpr int THREADS = BM / 32 * WARPS_N * 32;  // a warp a 32 x 32 patch
constexpr int K_STEP = 4;                       // one float4 of the depth
constexpr int PAD = 4;                          // floats after a row in shared memory

__host__ __device__ inline int padded_depth(int d) { return (d + K_STEP - 1) / K_STEP * K_STEP; }

__host__ __device__ inline long long smem_bytes(int d) {
  const long long ld = padded_depth(d) + PAD;
  return (BM + 2LL * LANES) * ld * 4 + (long long)BM * LANES * 4;
}

// rows [row0, row0 + rows) of a [n, d] matrix into shared memory at row stride
// ld, zeros past row n; columns [d, ld) are left as they are (zeroed once)
__device__ void load_rows(float* dst, const float* __restrict__ src, long long row0, int rows,
                          int n, int d, int ld, bool vec) {
  if (vec) {  // d is a multiple of 4 and src is 16-byte aligned
    const int chunks = d / 4;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i - r * chunks;
      const long long row = row0 + r;
      const bool valid = row < n;
      cp_async16(dst + r * ld + 4 * c, src + (valid ? row : 0) * d + 4 * c, valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      const long long row = row0 + r;
      dst[r * ld + c] = row < n ? src[row * d + c] : 0.f;
    }
  }
}

// The warp's 32 x 32 patch of one tile's scores. Thread (g = lane / 4, c =
// lane % 4) holds acc[mi][ni][r] for query wm * 32 + mi * 16 + g + 8 * (r / 2)
// and bin wn * 32 + ni * 8 + 2c + r % 2 (the m16n8 accumulator layout), each
// a chain of f32 FMA over k = 0 .. D-1.
__device__ __forceinline__ void tile_scores(float (&acc)[2][4][4], const float* qs,
                                            const float* it, int ld, int depth, int wm, int wn,
                                            int lane) {
  const int g = lane >> 2, c = lane & 3;
  for (int k = 0; k < depth; k += K_STEP) {
    float4 qv[2][2], iv[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qv[mi][h] = *reinterpret_cast<const float4*>(qs + (wm * 32 + mi * 16 + g + 8 * h) * ld + k);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        iv[ni][j] = *reinterpret_cast<const float4*>(it + (wn * 32 + ni * 8 + 2 * c + j) * ld + k);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 x = qv[mi][r >> 1], y = iv[ni][r & 1];
          float s = acc[mi][ni][r];
          s = fmaf(x.x, y.x, s);
          s = fmaf(x.y, y.y, s);
          s = fmaf(x.z, y.z, s);
          acc[mi][ni][r] = fmaf(x.w, y.w, s);
        }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
bin_max_f32_kernel(const float* __restrict__ queries, const float* __restrict__ items,
                   float* __restrict__ vals, int* __restrict__ idx, int n_queries, int n_items,
                   int d, int tiles_per_super, int n_query_tiles, int n_super, bool vec) {
  const int depth = padded_depth(d);
  const int ld = depth + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [BM, ld]
  float* stage[2] = {qs + BM * ld, qs + (BM + LANES) * ld};  // [128, ld] each
  int* best_tile = reinterpret_cast<int*>(qs + (BM + 2 * LANES) * ld);  // [BM, 128]

  const int qt = blockIdx.x % n_query_tiles, s = blockIdx.x / n_query_tiles;
  const int q0 = qt * BM;
  const long long sup = (long long)tiles_per_super * LANES;
  const long long s_row0 = s * sup;
  // tiles holding at least one id < V; the rest are wholly pad
  const int tiles = (int)min((long long)tiles_per_super, (n_items - s_row0 + LANES - 1) / LANES);

  // the depth's zero padding, once: the loads never write these columns
  if (depth > d) {
    for (int i = threadIdx.x; i < (BM + 2 * LANES) * (depth - d); i += blockDim.x) {
      const int r = i / (depth - d), c = d + i % (depth - d);
      qs[r * ld + c] = 0.f;
    }
  }
  load_rows(qs, queries, q0, BM, n_queries, d, ld, vec);
  load_rows(stage[0], items, s_row0, LANES, n_items, d, ld, vec);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, c = lane & 3;
  float best[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        best[mi][ni][r] = -INFINITY;
        // only this thread reads or writes its slots: no barrier needed
        best_tile[(wm * 32 + mi * 16 + g + 8 * (r >> 1)) * LANES + wn * 32 + ni * 8 + 2 * c + (r & 1)] = 0;
      }

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_rows(stage[(t + 1) & 1], items, s_row0 + (long long)(t + 1) * LANES, LANES, n_items, d,
                ld, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, the queries) is in

    float acc[2][4][4] = {};
    tile_scores(acc, qs, stage[t & 1], ld, depth, wm, wn, lane);
    const long long row0 = s_row0 + (long long)t * LANES;
    const bool tail = row0 + LANES > n_items;  // the tile holds pad ids
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int bin = wn * 32 + ni * 8 + 2 * c + (r & 1);
          const float score = tail && row0 + bin >= n_items ? PAD_SCORE : acc[mi][ni][r];
          if (score > best[mi][ni][r]) {
            best[mi][ni][r] = score;
            best_tile[(wm * 32 + mi * 16 + g + 8 * (r >> 1)) * LANES + bin] = t;
          }
        }
    __syncthreads();  // every warp is done with stage t & 1 before it is refilled
  }

  // the wholly pad tiles: the first of them puts PAD_SCORE where it is larger
  const bool pad_tiles = tiles < tiles_per_super;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ql = wm * 32 + mi * 16 + g + 8 * h;
      const int q = q0 + ql;
      if (q >= n_queries) continue;
      const long long out_row = ((long long)q * n_super + s) * LANES;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int bin = wn * 32 + ni * 8 + 2 * c;
        float v[2];
        int id[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = best[mi][ni][2 * h + j];
          int tile = best_tile[ql * LANES + bin + j];
          if (pad_tiles && PAD_SCORE > v[j]) {
            v[j] = PAD_SCORE;
            tile = tiles;
          }
          id[j] = (int)(s_row0 + (long long)tile * LANES + bin + j);
        }
        *reinterpret_cast<float2*>(vals + out_row + bin) = make_float2(v[0], v[1]);
        *reinterpret_cast<int2*>(idx + out_row + bin) = make_int2(id[0], id[1]);
      }
    }
}

int launch(const float* queries, const float* items, float* vals, int* idx, int n_queries,
           int n_items, int d, int tiles_per_super, int n_super, cudaStream_t stream) {
  const long long smem = smem_bytes(d);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bin_max_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_query_tiles = (n_queries + BM - 1) / BM;
  const long long blocks = (long long)n_query_tiles * n_super;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(items) % 16 == 0;
  bin_max_f32_kernel<<<(unsigned)blocks, THREADS, (size_t)smem, stream>>>(
      queries, items, vals, idx, n_queries, n_items, d, tiles_per_super, n_query_tiles, n_super,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// Shared memory bytes a block needs at depth d; dtype 0 = f32, 1 = bf16 (at
// its least number of item stages, 2; d a multiple of 8 there, as the wrapper
// pads it).
long long bin_max_smem_bytes(int d, int dtype) {
  if (d < 1) return -1;
  return dtype == 1 ? wg::smem_bytes(d, 2) : f32::smem_bytes(d);
}

// queries [n_queries, d] and items [n_items, d], both f32 (dtype 0) or bf16
// (dtype 1, d a multiple of 8, both 16-byte aligned), contiguous; vals
// [n_queries, n_super * 128] f32 and idx int32, where n_super =
// ceil(n_items / (tiles_per_super * 128)). Launch on `stream`; returns the
// cudaError_t of the launch (0 = success).
int bin_max_scores_fwd(const void* queries, const void* items, float* vals, int* idx, int n_queries,
                       int n_items, int d, int tiles_per_super, int n_super, int dtype,
                       void* stream) {
  if (n_queries < 1 || n_items < 1 || d < 1 || tiles_per_super < 1 || n_super < 1 ||
      (long long)n_super * tiles_per_super * LANES > 0x7fffffffLL ||
      (long long)(n_super - 1) * tiles_per_super * LANES >= n_items || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? wg::launch(queries, items, vals, idx, n_queries, n_items, d,
                                 tiles_per_super, n_super, s)
                    : f32::launch(static_cast<const float*>(queries),
                                  static_cast<const float*>(items), vals, idx, n_queries, n_items,
                                  d, tiles_per_super, n_super, s);
}

const char* bin_max_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
