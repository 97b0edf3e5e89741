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
// f32 FMA, while the bytes (the index read once, 256 MB bf16; the [4096, 3968]
// outputs, 130 MB) take 0.12 ms. So operations bound it; the point of the
// fusion is that the [B, V] score matrix (16 GB in f32) never exists.
//
// Design. A block takes one tile of BM queries and one whole super-chunk, so
// its [BM, 128] outputs are written once and no block depends on another (the
// TPU kernel's sequential revisit of its output block has no counterpart).
// The query tile stays in shared memory; the super-chunk's 128-row item tiles
// stream through two shared-memory stages (cp.async, zero-filled past V) in
// ascending id order. Each warp owns a 32 x 32 (query, bin) patch of the
// tile's score block, and each thread the same 32 (query, bin) pairs of every
// tile: it keeps their running max in registers and, where a tile's score is
// strictly larger, stores the tile number to its own slots of a shared [BM,
// 128] array. Ascending tiles and a strict > give the lowest id with no second
// comparison. bf16 items run warp-level mma.sync.m16n8k16 (bf16 products are
// exact in f32, f32 accumulation); f32 items run f32 FMA with the same
// ownership of pairs (TF32 is not used). Tiles wholly past V are not computed:
// they would put PAD_SCORE in every bin, which only a bin whose best is
// below PAD_SCORE takes, at the first such tile; that update runs once. The
// blocks that share a super-chunk are numbered together, query tile fastest,
// so a super-chunk (8 MB in bf16) is read from device memory once and from
// the L2 by each query tile. The K depth is zero-padded to the MMA's 16 (bf16)
// or to 4 (f32) in shared memory.
//
// Limits (the wrapper checks them before the launch): the query tile, two
// item stages and the tile numbers must fit a block's shared memory (D <= 208
// in bf16 and D <= 152 in f32 on the H100); ids are int32, so V and n_super *
// sup must stay below 2^31. wgmma, TMA, warp specialisation and fusing the
// final top-k are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANES = 128;  // bins of a super-chunk = item rows of a tile
constexpr int WARPS_N = LANES / 32;
constexpr float PAD_SCORE = -1e30f;

template <typename T>
struct Config;

template <>
struct Config<__nv_bfloat16> {
  static constexpr int BM = 128;                       // queries a block
  static constexpr int THREADS = BM / 32 * WARPS_N * 32;  // a warp a 32 x 32 patch
  static constexpr int K_STEP = 16;                    // the MMA's depth
  static constexpr int PAD = 8;  // elements after a row in shared memory (conflict-free ldmatrix)
};

template <>
struct Config<float> {
  static constexpr int BM = 64;
  static constexpr int THREADS = BM / 32 * WARPS_N * 32;
  static constexpr int K_STEP = 4;  // one float4 of the depth
  static constexpr int PAD = 4;
};

__host__ __device__ inline int padded_depth(int d, int k_step) { return (d + k_step - 1) / k_step * k_step; }

template <typename T>
__host__ __device__ inline long long smem_bytes_of(int d) {
  const long long ld = padded_depth(d, Config<T>::K_STEP) + Config<T>::PAD;
  return (Config<T>::BM + 2LL * LANES) * ld * (long long)sizeof(T) +
         (long long)Config<T>::BM * LANES * 4;
}

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

// rows [row0, row0 + rows) of a [n, d] matrix into shared memory at row stride
// ld, zeros past row n; columns [d, ld) are left as they are (zeroed once)
template <typename T>
__device__ void load_rows(T* dst, const T* __restrict__ src, long long row0, int rows, int n, int d,
                          int ld, bool vec) {
  if (vec) {  // d * sizeof(T) is a multiple of 16 and src is 16-byte aligned
    const int chunks = d * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i - r * chunks;
      const long long row = row0 + r;
      const bool valid = row < n;
      const char* from = reinterpret_cast<const char*>(src + (valid ? row : 0) * d) + 16 * c;
      cp_async16(reinterpret_cast<char*>(dst + r * ld) + 16 * c, from, valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      const long long row = row0 + r;
      dst[r * ld + c] = row < n ? src[row * d + c] : T(0.f);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's 32 x 32 patch of one tile's scores. Thread (g = lane / 4, c =
// lane % 4) holds acc[mi][ni][r] for query wm * 32 + mi * 16 + g + 8 * (r / 2)
// and bin wn * 32 + ni * 8 + 2c + r % 2: the m16n8 accumulator layout of
// mma.sync, which the f32 version keeps so the rest of the kernel is shared.
__device__ __forceinline__ void tile_scores(float (&acc)[2][4][4], const __nv_bfloat16* qs,
                                            const __nv_bfloat16* it, int ld, int depth, int wm,
                                            int wn, int lane) {
  for (int k0 = 0; k0 < depth; k0 += 16) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], qs + (wm * 32 + mi * 16 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      unsigned r[4];
      ldmatrix_x4(r, it + (wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                         ((lane >> 3) & 1) * 8);
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

__device__ __forceinline__ void tile_scores(float (&acc)[2][4][4], const float* qs, const float* it,
                                            int ld, int depth, int wm, int wn, int lane) {
  const int g = lane >> 2, c = lane & 3;
  for (int k = 0; k < depth; k += 4) {
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

template <typename T>
__global__ void __launch_bounds__(Config<T>::THREADS, 1)
bin_max_kernel(const T* __restrict__ queries, const T* __restrict__ items, float* __restrict__ vals,
               int* __restrict__ idx, int n_queries, int n_items, int d, int tiles_per_super,
               int n_query_tiles, int n_super, bool vec) {
  constexpr int BM = Config<T>::BM;
  const int depth = padded_depth(d, Config<T>::K_STEP);
  const int ld = depth + Config<T>::PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BM, ld]
  T* stage[2] = {qs + BM * ld, qs + (BM + LANES) * ld};  // [128, ld] each
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
      qs[r * ld + c] = T(0.f);
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

template <typename T>
int launch(const void* queries, const void* items, float* vals, int* idx, int n_queries,
           int n_items, int d, int tiles_per_super, int n_super, cudaStream_t stream) {
  const long long smem = smem_bytes_of<T>(d);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bin_max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_query_tiles = (n_queries + Config<T>::BM - 1) / Config<T>::BM;
  const long long blocks = (long long)n_query_tiles * n_super;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec = (d * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(queries) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(items) % 16 == 0;
  bin_max_kernel<T><<<(unsigned)blocks, Config<T>::THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(items), vals, idx, n_queries, n_items,
      d, tiles_per_super, n_query_tiles, n_super, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory bytes a block needs at depth d; dtype 0 = f32, 1 = bf16.
long long bin_max_smem_bytes(int d, int dtype) {
  if (d < 1) return -1;
  return dtype == 1 ? smem_bytes_of<__nv_bfloat16>(d) : smem_bytes_of<float>(d);
}

// queries [n_queries, d] and items [n_items, d], both f32 (dtype 0) or bf16
// (dtype 1), contiguous; vals [n_queries, n_super * 128] f32 and idx int32,
// where n_super = ceil(n_items / (tiles_per_super * 128)). Launch on `stream`;
// returns the cudaError_t of the launch (0 = success).
int bin_max_scores_fwd(const void* queries, const void* items, float* vals, int* idx, int n_queries,
                       int n_items, int d, int tiles_per_super, int n_super, int dtype,
                       void* stream) {
  if (n_queries < 1 || n_items < 1 || d < 1 || tiles_per_super < 1 || n_super < 1 ||
      (long long)n_super * tiles_per_super * LANES > 0x7fffffffLL ||
      (long long)(n_super - 1) * tiles_per_super * LANES >= n_items || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(queries, items, vals, idx, n_queries, n_items, d,
                                            tiles_per_super, n_super, s)
                    : launch<float>(queries, items, vals, idx, n_queries, n_items, d,
                                    tiles_per_super, n_super, s);
}

const char* bin_max_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
