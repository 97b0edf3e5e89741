// DIN attention pooling for Hopper (sm_90a), f32.
//
// Replaces pytorchrec_tpu/ops/kernels/din_attention.py::_make_din_kernel (the
// pl.pallas_call of din_attention_pool_pallas). For a history his [B, S, E], the
// candidates tgt [B, N, E], a validity mask valid [B, S] (nonzero = valid) and
// a score MLP w_0 [4E, H_1], b_0 [H_1], ..., w_k [H_k, 1], b_k [1] (flax's
// [in, out] layout), each (b, n) row gets
//     a_s      = [h_s, t, h_s - t, h_s * t]        (h_s = his[b, s], t = tgt[b, n])
//     z_s      = act(... act(a_s w_0 + b_0) ...) w_k + b_k    (act: sigmoid or relu)
//     z_s      = -inf where valid[b, s] == 0
//     out[b,n] = sum_s softmax_s(z)_s * h_s
// A row whose steps are all masked gives NaN, as the plain version does.
//
// Bound: operations. Since a_s w_0 = h_s (w_a + w_c) + t (w_b - w_c) + (h_s * t) w_d
// exactly (w_0's four row blocks), the least work runs the h part once a (b, s),
// the t part once a (b, n), and for each (b, n, s) pair only h_s * t, its product
// with w_d, the later layers and the pool: 3.7 GFLOP for the training step's
// [4096, 2, 20] call at E=64 and hidden (80, 40), 0.055 ms at the 67 TFLOP/s of
// f32 FMA, while its bytes (his, tgt, valid, out: 25 MB) take 0.008 ms. This
// kernel runs the split form with the t part once a (b, n) row of a tile and the
// h part per pair: 4.6 GFLOP there, where the concat form (all of w_0 for every
// pair) is 7.8.
//
// Design. The TPU kernel takes 64 batch rows a grid step, unrolls the candidate
// axis and runs the MLP as 2-D matmuls in VMEM, with the batch padded to its
// block. Here a persistent block (one an SM) loads every weight and bias into
// shared memory once, w_0 as the three [E, H_1] blocks w_h = w_a + w_c,
// w_t = w_b - w_c and w_d, formed in f32 as they are copied (61 KB at E=64, so
// the block asks for dynamic shared memory above 48 KB). It then walks tiles
// of whole (b, n) rows: as many rows as fill a chunk of 8 pairs a warp (128
// pairs with 16 warps; 6 rows at S=20), their (n, s) pairs run through the
// MLP a chunk at a time. The block stages each row's candidate once in shared
// memory and forms its t part u = b_0 + t w_t there, once a row of the tile;
// each warp stages its own 8 pairs' history rows (8 loads in flight a lane)
// and runs them through every layer alone, synchronising only with itself, so
// the warps of a block overlap loads with arithmetic. Each lane owns the
// columns lane, lane + 32, ... of a layer (four at a time: a wider layer runs
// in passes of 128 columns), so a weight read serves 8 pairs and a history
// read all the lane's columns of the pass. Layer 0 takes h and h * t in
// registers: h w_h + (h * t) w_d, two weight reads and two FMAs a pair and
// column, plus the pair's row of u; it reads the staged rows 16 bytes at a
// time where E is a multiple of 4. Hidden activations ping-pong between two
// [chunk, H] buffers; the linear head is a dot product a warp, reduced with
// shuffles, and the masked score lands in a per-tile score buffer. When the
// tile's pairs are done, a warp a row takes the softmax over S and the weighted
// sum of the history rows (from shared memory where the tile was one chunk).
// Nothing is padded: pairs
// past a tile's end compute on zeros (and the tile's last row of u) and are
// dropped. f32 FMA only. Left for later work: the h part once a (b, s) across
// the candidates (it runs for every pair here), the lanes wasted where a
// layer's width is not a multiple of 32 (80 and 40 leave 16 of 96 and 24 of 64
// lane columns idle), and tensor cores.
//
// Limits (the wrapper checks them before the launch): 1 to 7 hidden layers;
// S <= 8192; the shared memory must fit the device's per-block limit (194 KB at
// E=64, S=20 and (80, 40)), which is what bounds a layer's width. Each row of a
// tile holds its candidate, its t part and its scores there, so where a whole
// chunk's rows would not fit (a wide first layer at a small S) a tile takes
// fewer rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int PAIRS_PER_WARP = 8;
constexpr int CHUNK = WARPS * PAIRS_PER_WARP;  // (n, s) pairs through the MLP at once
constexpr int MAX_LAYERS = 8;                  // hidden layers and the head
constexpr int MAX_COLS = 4;                    // columns a lane in one pass of a layer
constexpr int MAX_STEPS = 8192;

struct Mlp {
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
  int dim[MAX_LAYERS + 1];  // dim[0] = 4E, dim[l + 1] = width of layer l, the head's 1
  int w_off[MAX_LAYERS];    // float offsets of w_l and b_l in shared memory; w_0 is
                            // there as w_h, w_t and w_d, [E, H_1] each
  int b_off[MAX_LAYERS];
  int layers;               // hidden layers + 1
  int tile_rows;            // (b, n) rows a tile
  int weight_floats;
  int widest;               // widest hidden layer
};

// relu keeps a NaN, as torch.relu does
__device__ __forceinline__ float activate(float x, int act) {
  return act == 0 ? 1.f / (1.f + expf(-x)) : (x < 0.f ? 0.f : x);
}

// Activations keep a row stride of `stride` (the widest hidden layer) at every
// layer, so a warp's rows of a buffer are the same at every layer and never
// overlap another warp's: the warps need not wait for one another. Pair i of
// the warp adds the bias row bias + row[i] * width (a layer after the first:
// the same row for every pair).
template <int RC>
__device__ __forceinline__ void store_layer(int col0, const float (&acc)[PAIRS_PER_WARP][RC],
                                            const float* bias, const int (&row)[PAIRS_PER_WARP],
                                            int width, int act, float* out, int stride) {
  const int lane = threadIdx.x & 31, p0 = (threadIdx.x >> 5) * PAIRS_PER_WARP;
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    const int j = col0 + lane + 32 * c;
    if (j < width) {
#pragma unroll
      for (int i = 0; i < PAIRS_PER_WARP; ++i)
        out[(p0 + i) * stride + j] = activate(acc[i][c] + bias[row[i] * width + j], act);
    }
  }
}

// Layer 0, columns [col0, col0 + 32 RC), in the split form: h w_h + (h * t) w_d
// for the warp's pairs, from the staged rows (h a pair, t a (b, n) row), plus
// the pair's row of u = b_0 + t w_t. Where E is a multiple of 4 the rows are
// read 4 steps of e at a time (16-byte loads, the same sums in the same order):
// shared-memory loads, not FMAs, set this loop's pace.
template <int RC>
__device__ void feature_layer(int col0, const float* hs, const float* ts, const int (&row)[PAIRS_PER_WARP],
                              int e_dim, const float* w_h, const float* w_d, const float* u,
                              int width, int act, float* out, int stride) {
  const int lane = threadIdx.x & 31, p0 = (threadIdx.x >> 5) * PAIRS_PER_WARP;
  float acc[PAIRS_PER_WARP][RC] = {};
  const int e_vec = e_dim % 4 == 0 ? e_dim : 0;
  for (int e = 0; e < e_vec; e += 4) {
    float wh[4][RC], wd[4][RC];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int j = col0 + lane + 32 * c;
        wh[q][c] = j < width ? w_h[(e + q) * width + j] : 0.f;
        wd[q][c] = j < width ? w_d[(e + q) * width + j] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < PAIRS_PER_WARP; ++i) {
      const float4 h4 = *reinterpret_cast<const float4*>(hs + (p0 + i) * e_dim + e);
      const float4 t4 = *reinterpret_cast<const float4*>(ts + row[i] * e_dim + e);
      const float h[4] = {h4.x, h4.y, h4.z, h4.w};
      const float ht[4] = {h4.x * t4.x, h4.y * t4.y, h4.z * t4.z, h4.w * t4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c = 0; c < RC; ++c)
          acc[i][c] = fmaf(ht[q], wd[q][c], fmaf(h[q], wh[q][c], acc[i][c]));
      }
    }
  }
  for (int e = e_vec; e < e_dim; ++e) {
    float h[PAIRS_PER_WARP], ht[PAIRS_PER_WARP];
#pragma unroll
    for (int i = 0; i < PAIRS_PER_WARP; ++i) {
      h[i] = hs[(p0 + i) * e_dim + e];
      ht[i] = h[i] * ts[row[i] * e_dim + e];
    }
    float wh[RC], wd[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int j = col0 + lane + 32 * c;
      wh[c] = j < width ? w_h[e * width + j] : 0.f;
      wd[c] = j < width ? w_d[e * width + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PAIRS_PER_WARP; ++i) {
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[i][c] = fmaf(ht[i], wd[c], fmaf(h[i], wh[c], acc[i][c]));
    }
  }
  store_layer<RC>(col0, acc, u, row, width, act, out, stride);
}

// A hidden layer after the first, columns [col0, col0 + 32 RC):
// x [pairs, k_dim] -> out [pairs, width].
template <int RC>
__device__ void dense_layer(int col0, const float* x, int k_dim, const float* w, const float* bias,
                            int width, int act, float* out, int stride) {
  const int lane = threadIdx.x & 31, p0 = (threadIdx.x >> 5) * PAIRS_PER_WARP;
  float acc[PAIRS_PER_WARP][RC] = {};
  const int same_row[PAIRS_PER_WARP] = {};
  for (int k = 0; k < k_dim; ++k) {
    float wv[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int j = col0 + lane + 32 * c;
      wv[c] = j < width ? w[k * width + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PAIRS_PER_WARP; ++i) {
      const float xv = x[(p0 + i) * stride + k];
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[i][c] = fmaf(xv, wv[c], acc[i][c]);
    }
  }
  store_layer<RC>(col0, acc, bias, same_row, width, act, out, stride);
}

// LAYER<columns a lane>(col0, args...) over a layer WIDTH wide, 128 columns a
// pass. The passes write disjoint columns of a buffer the layer does not read.
#define DIN_BY_COLUMNS(LAYER, WIDTH, ...)                                   \
  for (int col0 = 0; col0 < (WIDTH); col0 += 32 * MAX_COLS) {              \
    switch (min(MAX_COLS, ((WIDTH) - col0 + 31) / 32)) {                   \
      case 1: LAYER<1>(col0, __VA_ARGS__); break;                          \
      case 2: LAYER<2>(col0, __VA_ARGS__); break;                          \
      case 3: LAYER<3>(col0, __VA_ARGS__); break;                          \
      default: LAYER<MAX_COLS>(col0, __VA_ARGS__); break;                  \
    }                                                                       \
  }

// the most (b, n) rows a tile holds: as many as fill a chunk, at least one
inline int rows_per_tile(int steps) {
  return steps < CHUNK ? CHUNK / steps : 1;
}

__global__ void __launch_bounds__(THREADS, 1)
din_attention_kernel(const float* __restrict__ his, const float* __restrict__ tgt,
                     const int* __restrict__ valid, const Mlp mlp, float* __restrict__ out,
                     int batch, int n_cand, int steps, int e_dim, int act) {
  const int tile_rows_max = mlp.tile_rows;
  extern __shared__ float smem[];
  float* weights = smem;
  float* hs = weights + mlp.weight_floats;  // [CHUNK, E] history row of each pair
  float* ts = hs + CHUNK * e_dim;           // [rows a tile, E] candidate row of each (b, n)
  float* u = ts + tile_rows_max * e_dim;    // [rows a tile, H_1] t part of each (b, n)
  float* act_a = u + tile_rows_max * mlp.dim[1];  // [CHUNK, widest]
  float* act_b = act_a + CHUNK * mlp.widest;
  float* scores = act_b + CHUNK * mlp.widest;  // [rows a tile * S]

  const int h1 = mlp.dim[1], block0 = e_dim * h1;  // w_0's row blocks: [E, H_1] each
  float* w_h = weights + mlp.w_off[0];
  float* w_t = w_h + block0;
  float* w_d = w_t + block0;
  for (int i = threadIdx.x; i < block0; i += THREADS) {
    const float* w0 = mlp.w[0] + i;
    const float w_a = w0[0], w_b = w0[block0], w_c = w0[2 * block0];
    w_h[i] = w_a + w_c;
    w_t[i] = w_b - w_c;
    w_d[i] = w0[3 * block0];
  }
  for (int l = 0; l < mlp.layers; ++l) {
    const int n_w = l == 0 ? 0 : mlp.dim[l] * mlp.dim[l + 1];
    for (int i = threadIdx.x; i < n_w; i += THREADS) weights[mlp.w_off[l] + i] = mlp.w[l][i];
    for (int i = threadIdx.x; i < mlp.dim[l + 1]; i += THREADS)
      weights[mlp.b_off[l] + i] = mlp.b[l][i];
  }
  const float* b_0 = weights + mlp.b_off[0];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = warp * PAIRS_PER_WARP;  // the warp's pairs in a chunk
  const long long rows = (long long)batch * n_cand;
  const long long tiles = (rows + tile_rows_max - 1) / tile_rows_max;
  const int last = mlp.layers - 1;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * tile_rows_max;
    const int tile_rows = (int)min((long long)tile_rows_max, rows - row0);
    const int tile_pairs = tile_rows * steps;
    __syncthreads();  // the weights are in; the last tile's pooling is done
    for (int r = warp; r < tile_rows; r += WARPS)
      for (int e = lane; e < e_dim; e += 32) ts[r * e_dim + e] = tgt[(row0 + r) * e_dim + e];
    __syncthreads();
    // the t part of layer 0, once a row: u[r] = b_0 + ts[r] w_t
    for (int i = threadIdx.x; i < tile_rows * h1; i += THREADS) {
      const int r = i / h1, j = i - r * h1;
      float acc = b_0[j];
      for (int e = 0; e < e_dim; ++e) acc = fmaf(ts[r * e_dim + e], w_t[e * h1 + j], acc);
      u[i] = acc;
    }
    __syncthreads();
    // From here to the scores a warp touches only its own pairs' rows of hs
    // and of the activations, so it runs on without waiting for the others.
    for (int c0 = 0; c0 < tile_pairs; c0 += CHUNK) {
      const float* src[PAIRS_PER_WARP];
      int row[PAIRS_PER_WARP];  // each pair's (b, n) row in the tile, clamped inside it
#pragma unroll
      for (int i = 0; i < PAIRS_PER_WARP; ++i) {
        const int pt = c0 + p0 + i, r = pt / steps, s = pt - r * steps;
        src[i] = pt < tile_pairs ? his + ((row0 + r) / n_cand * steps + s) * e_dim : nullptr;
        row[i] = min(r, tile_rows - 1);
      }
      for (int e = lane; e < e_dim; e += 32) {
        float v[PAIRS_PER_WARP];
#pragma unroll
        for (int i = 0; i < PAIRS_PER_WARP; ++i) v[i] = src[i] ? __ldg(src[i] + e) : 0.f;
#pragma unroll
        for (int i = 0; i < PAIRS_PER_WARP; ++i) hs[(p0 + i) * e_dim + e] = v[i];
      }
      __syncwarp();
      DIN_BY_COLUMNS(feature_layer, h1, hs, ts, row, e_dim, w_h, w_d, u, h1, act, act_a,
                     mlp.widest)
      __syncwarp();
      float* x = act_a;
      float* y = act_b;
      for (int l = 1; l < last; ++l) {
        DIN_BY_COLUMNS(dense_layer, mlp.dim[l + 1], x, mlp.dim[l],
                       weights + mlp.w_off[l], weights + mlp.b_off[l], mlp.dim[l + 1], act, y,
                       mlp.widest)
        __syncwarp();
        float* swap = x;
        x = y;
        y = swap;
      }
      // the linear head: a dot product of each pair's last activations, reduced
      // over the warp
      const int k_dim = mlp.dim[last];
      const float* w_head = weights + mlp.w_off[last];
      const float b_head = weights[mlp.b_off[last]];
#pragma unroll
      for (int i = 0; i < PAIRS_PER_WARP; ++i) {
        float z = 0.f;
        for (int k = lane; k < k_dim; k += 32) z = fmaf(x[(p0 + i) * mlp.widest + k], w_head[k], z);
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1) z += __shfl_xor_sync(0xffffffffu, z, offset);
        const int pt = c0 + p0 + i;
        if (lane == 0 && pt < tile_pairs) {
          const int r = pt / steps, s = pt - r * steps;
          const long long b = (row0 + r) / n_cand;
          scores[pt] = valid[b * steps + s] != 0 ? z + b_head : -INFINITY;
        }
      }
      __syncwarp();  // the head has read the activations before the next chunk's layers
    }
    __syncthreads();  // every pair's score is in
    // softmax over S and the weighted sum of the history rows, a warp a row;
    // a tile of one chunk still holds its history rows in hs
    const bool staged = tile_pairs <= CHUNK;
    for (int r = warp; r < tile_rows; r += WARPS) {
      const long long row = row0 + r, b = row / n_cand;
      float* sc = scores + r * steps;
      float m = -INFINITY;
      for (int s = lane; s < steps; s += 32) m = fmaxf(m, sc[s]);
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
      float sum = 0.f;
      for (int s = lane; s < steps; s += 32) {
        const float ex = expf(sc[s] - m);  // NaN where every step is masked
        sc[s] = ex;
        sum += ex;
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, offset);
      for (int s = lane; s < steps; s += 32) sc[s] = sc[s] / sum;
      __syncwarp();
      const float* hb = staged ? hs + r * steps * e_dim : his + b * steps * e_dim;
      for (int e = lane; e < e_dim; e += 32) {
        float acc = 0.f;
        for (int s = 0; s < steps; ++s) acc = fmaf(sc[s], hb[(long long)s * e_dim + e], acc);
        out[row * e_dim + e] = acc;
      }
    }
  }
}

// Fills `mlp` from the layer widths and the rows a tile; returns the shared
// memory bytes a block needs, or -1 where they are outside the kernel's limits.
// The wrapper picks the rows (ops/kernels/din_attention.py::tile_plan, whose
// smem_bytes computes the same bytes): fewer than fill a chunk where a block of
// that many would not fit.
long long plan(int e_dim, int steps, const int* dims, int layers, int tile_rows, Mlp* mlp) {
  if (e_dim < 1 || steps < 1 || steps > MAX_STEPS || layers < 2 || layers > MAX_LAYERS ||
      dims[0] != 4 * e_dim || dims[layers] != 1 || tile_rows < 1 ||
      tile_rows > rows_per_tile(steps))
    return -1;
  long long off = 0;
  int widest = 1;
  for (int l = 0; l < layers; ++l) {
    if (l > 0 && dims[l] < 1) return -1;
    if (l > 0 && dims[l] > widest) widest = dims[l];
    mlp->dim[l] = dims[l];
    mlp->w_off[l] = (int)off;
    off += (long long)(l == 0 ? 3 * e_dim : dims[l]) * dims[l + 1];  // w_0 as w_h, w_t, w_d
    mlp->b_off[l] = (int)off;
    off += dims[l + 1];
  }
  off = (off + 3) / 4 * 4;  // the staged rows start on 16 bytes
  mlp->dim[layers] = 1;
  mlp->layers = layers;
  mlp->weight_floats = (int)off;
  mlp->widest = widest;
  mlp->tile_rows = tile_rows;
  const long long rows = tile_rows;
  return 4 * (off + (long long)CHUNK * e_dim + rows * (e_dim + dims[1]) + 2LL * CHUNK * widest +
              rows * steps);
}

}  // namespace

extern "C" {

// Shared memory bytes a block needs at `tile_rows` (b, n) rows a tile, or -1
// outside the kernel's limits.
long long din_attention_smem_bytes(int e_dim, int steps, const int* dims, int layers,
                                   int tile_rows) {
  Mlp mlp;
  return plan(e_dim, steps, dims, layers, tile_rows, &mlp);
}

// his [batch, steps, e_dim], tgt [batch, n_cand, e_dim], valid [batch, steps]
// int32, weights[l] [dims[l], dims[l + 1]] and biases[l] [dims[l + 1]] f32 for
// l < layers, out [batch, n_cand, e_dim]; all contiguous, on the current device.
// activation 0 = sigmoid, 1 = relu; tile_rows (b, n) rows a tile. Launch on
// `stream`; returns the cudaError_t of the launch (0 = success).
int din_attention_fwd(const float* his, const float* tgt, const int* valid,
                      const void* const* weights, const void* const* biases, const int* dims,
                      int layers, float* out, int batch, int n_cand, int steps, int e_dim,
                      int activation, int tile_rows, void* stream) {
  Mlp mlp;
  const long long smem = plan(e_dim, steps, dims, layers, tile_rows, &mlp);
  if (smem < 0 || batch < 1 || n_cand < 1 || (activation != 0 && activation != 1))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < layers; ++l) {
    mlp.w[l] = static_cast<const float*>(weights[l]);
    mlp.b[l] = static_cast<const float*>(biases[l]);
  }
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(din_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one block an SM: it holds the weights for the whole launch
  const long long rows = (long long)batch * n_cand;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  din_attention_kernel<<<grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      his, tgt, valid, mlp, out, batch, n_cand, steps, e_dim, activation);
  return (int)cudaGetLastError();
}

const char* din_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
