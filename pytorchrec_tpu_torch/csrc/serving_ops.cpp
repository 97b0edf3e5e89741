// The scoring kernels as torch operators for the Python-free server
// (native/serving/aoti_serving.cpp): the schemas of ops/kernels/__init__.py's
// SCHEMAS, registered with TORCH_LIBRARY in the pytorchrec namespace. An
// AOTInductor package that holds these ops calls them through the dispatcher,
// so the server dlopens this library before it loads a package. A Python
// process never loads it: its ops are ops/kernels/*.py's, and the two would
// clash.
//
// CUDA: each op launches its hand-written kernel (cross.cu, fm.cu,
// din_attention.cu, linked into this library) through the kernel's C entry
// point on c10::cuda::getCurrentCUDAStream(), with the plan of
// serving_plans.h (Python's plan, line for line), checks the returned error
// and throws on it. There is no other path for a CUDA tensor. CPU: the plain
// versions, as ops/kernels/*.py's CPU implementations. Each op counts its
// kernel launches; pytorchrec_serving_launches(name) reads the count.
//
// Built by ops/kernels/build.py::serving_ops_library: g++ alone for the CPU
// (SERVING_OPS_CUDA undefined), g++ and nvcc for the card.

#include <ATen/core/Tensor.h>
#include <ATen/ops/cat.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/zeros.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

#include "serving_plans.h"

#ifdef SERVING_OPS_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>

extern "C" {
// cross.cu
long long cross_network_smem_bytes(int d);
int cross_network_fwd(const float* x0, const float* ws, const float* bs, float* out, int batch,
                      int d, int layers, void* stream);
int cross_network_tiled_fwd(const float* x0, const float* ws, const float* bs, float* out,
                            float* buf, int batch, int d, int layers, int config, int slice_k,
                            int ldw, void* stream);
const char* cross_network_error_string(int code);
// fm.cu
int fm_fwd(const float* v, float* out, int batch, int f, int e, void* stream);
const char* fm_error_string(int code);
// din_attention.cu
int din_attention_fwd(const float* his, const float* tgt, const int* valid,
                      const void* const* weights, const void* const* biases, const int* dims,
                      int layers, float* out, int batch, int n_cand, int steps, int e_dim,
                      int activation, int tile_rows, void* stream);
const char* din_attention_error_string(int code);
}
#endif

namespace {

namespace plans = pytorchrec_serving;

const char* const kOps[] = {"cross_network", "fm_interaction", "din_attention_pool"};
std::atomic<long long> g_launches[3];

void CheckF32(const at::Tensor& t, const char* name, const at::Tensor& first) {
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32, got ", t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.device() == first.device(), name, " is on ", t.device(), ", not ",
              first.device());
}

void CheckCross(const at::Tensor& x0, const at::Tensor& ws, const at::Tensor& bs) {
  TORCH_CHECK(x0.dim() == 2 && ws.dim() == 3 && bs.dim() == 2,
              "cross_network wants x0 [B, D], ws [L, D, D], bs [L, D]");
  const int64_t d = x0.size(1), layers = ws.size(0);
  TORCH_CHECK(ws.size(1) == d && ws.size(2) == d && bs.size(0) == layers && bs.size(1) == d,
              "cross_network: ws / bs do not fit D=", d);
  CheckF32(x0, "x0", x0);
  CheckF32(ws, "ws", x0);
  CheckF32(bs, "bs", x0);
}

void CheckDin(const at::Tensor& his, const at::Tensor& tgt, const at::Tensor& valid,
              const std::vector<at::Tensor>& params, const std::string& activation) {
  TORCH_CHECK(activation == "sigmoid" || activation == "relu",
              "din_attention_pool: activation must be sigmoid or relu, got ", activation);
  TORCH_CHECK(his.dim() == 3 && tgt.dim() == 3 && valid.dim() == 2,
              "din_attention_pool wants his [B, S, E], tgt [B, N, E], valid [B, S]");
  const int64_t b = his.size(0), s = his.size(1), e = his.size(2);
  TORCH_CHECK(tgt.size(0) == b && tgt.size(2) == e && valid.size(0) == b && valid.size(1) == s,
              "din_attention_pool: tgt / valid do not fit his");
  TORCH_CHECK(params.size() >= 4 && params.size() % 2 == 0,
              "din_attention_pool wants (w_0, b_0, ..., w_k, b_k) with a hidden layer");
  int64_t width = 4 * e;
  for (size_t i = 0; i < params.size(); i += 2) {
    const at::Tensor& w = params[i];
    const at::Tensor& bias = params[i + 1];
    const int64_t out = i + 2 == params.size() ? 1 : w.size(-1);
    TORCH_CHECK(w.dim() == 2 && w.size(0) == width && w.size(1) == out && bias.dim() == 1 &&
                    bias.size(0) == out,
                "din_attention_pool: layer ", i / 2, " does not fit");
    width = out;
    CheckF32(w, "a weight", his);
    CheckF32(bias, "a bias", his);
  }
  CheckF32(his, "his", his);
  CheckF32(tgt, "tgt", his);
  TORCH_CHECK(valid.scalar_type() == at::kInt && valid.is_contiguous() &&
                  valid.device() == his.device(),
              "din_attention_pool: valid must be contiguous int32 beside his");
}

// ----------------------------------------------------------- plain versions

at::Tensor CrossCpu(const at::Tensor& x0, const at::Tensor& ws, const at::Tensor& bs) {
  CheckCross(x0, ws, bs);
  at::Tensor xl = x0.clone();
  for (int64_t l = 0; l < ws.size(0); ++l) xl = x0.mul(xl.matmul(ws[l]).add(bs[l])).add(xl);
  return xl;
}

at::Tensor FmCpu(const at::Tensor& v) {
  TORCH_CHECK(v.dim() == 3, "fm_interaction wants v [B, F, E]");
  CheckF32(v, "v", v);
  const at::Tensor sum_of_fields = v.sum(1);
  const at::Tensor sum_of_squares = v.square().sum(1);
  return sum_of_fields.square().sub(sum_of_squares).sum(-1).mul(0.5);
}

at::Tensor DinCpu(const at::Tensor& his, const at::Tensor& tgt, const at::Tensor& valid,
                  at::TensorList params_list, c10::string_view activation_view) {
  const std::vector<at::Tensor> params = params_list.vec();
  const std::string activation(activation_view.data(), activation_view.size());
  CheckDin(his, tgt, valid, params, activation);
  const int64_t b = his.size(0), s = his.size(1), e = his.size(2), n = tgt.size(1);
  const at::Tensor his_b = his.unsqueeze(1).expand({b, n, s, e});
  const at::Tensor tgt_b = tgt.unsqueeze(2).expand({b, n, s, e});
  at::Tensor a = at::cat({his_b, tgt_b, his_b.sub(tgt_b), his_b.mul(tgt_b)}, -1);
  const size_t last = params.size() - 2;
  for (size_t i = 0; i < last; i += 2) {
    a = a.matmul(params[i]).add(params[i + 1]);
    a = activation == "sigmoid" ? a.sigmoid() : a.relu();
  }
  at::Tensor scores = a.matmul(params[last]).add(params[last + 1]).select(-1, 0);
  scores = scores.masked_fill(valid.unsqueeze(1).eq(0), -std::numeric_limits<float>::infinity());
  return scores.softmax(-1).bmm(his);
}

// ------------------------------------------------------------------ kernels

#ifdef SERVING_OPS_CUDA

int DeviceAttribute(cudaDeviceAttr attr, int device) {
  int value = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&value, attr, device);
  TORCH_CHECK(err == cudaSuccess, "cudaDeviceGetAttribute: ", cudaGetErrorString(err));
  return value;
}

at::Tensor CrossCuda(const at::Tensor& x0, const at::Tensor& ws, const at::Tensor& bs) {
  CheckCross(x0, ws, bs);
  const int64_t batch = x0.size(0), d = x0.size(1), layers = ws.size(0);
  TORCH_CHECK(layers >= 1, "cross_network: the op takes L >= 1 layers");
  TORCH_CHECK(batch * d < (1LL << 31) && d * d < (1LL << 31), "cross_network: shape exceeds ",
              "the kernel's int32 indexing");
  at::Tensor out = at::empty_like(x0);
  if (batch == 0) return out;
  const c10::cuda::CUDAGuard guard(x0.device());
  const int device = x0.device().index();
  const plans::CrossPlan plan =
      plans::PlanCross(batch, static_cast<int>(d),
                       DeviceAttribute(cudaDevAttrMultiProcessorCount, device));
  void* stream = c10::cuda::getCurrentCUDAStream(device).stream();
  int err = 0;
  if (plan.fused) {
    const long long smem = cross_network_smem_bytes(static_cast<int>(d));
    const int limit = DeviceAttribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    TORCH_CHECK(d <= plans::kFusedMaxWidth && smem <= limit, "the fused cross kernel needs ",
                smem, " B of shared memory at D=", d, "; the device allows ", limit, " B a block");
    err = cross_network_fwd(x0.data_ptr<float>(), ws.data_ptr<float>(), bs.data_ptr<float>(),
                            out.data_ptr<float>(), static_cast<int>(batch), static_cast<int>(d),
                            static_cast<int>(layers), stream);
  } else {
    at::Tensor buf = at::empty({std::min<int64_t>(layers - 1, 2), batch, d}, x0.options());
    // cross.py's _launch: W rows of a multiple of 4 floats, zero past D, on
    // 16 bytes, for every tile but the rows tile
    at::Tensor wp = ws;
    if (!plans::RowsTile(plan.tile) && d % 4) {
      wp = at::zeros({layers, d, d + (4 - d % 4)}, ws.options());
      wp.narrow(2, 0, d).copy_(ws);
    } else if (!plans::RowsTile(plan.tile) && reinterpret_cast<uintptr_t>(ws.data_ptr()) % 16) {
      wp = ws.clone();
    }
    err = cross_network_tiled_fwd(x0.data_ptr<float>(), wp.data_ptr<float>(),
                                  bs.data_ptr<float>(), out.data_ptr<float>(),
                                  buf.data_ptr<float>(), static_cast<int>(batch),
                                  static_cast<int>(d), static_cast<int>(layers), plan.tile,
                                  plan.slice_k, static_cast<int>(wp.size(2)), stream);
  }
  TORCH_CHECK(err == 0, "cross_network ", plan.fused ? "fused" : "tiled",
              " kernel launch failed: ", cross_network_error_string(err));
  ++g_launches[0];
  return out;
}

at::Tensor FmCuda(const at::Tensor& v) {
  TORCH_CHECK(v.dim() == 3, "fm_interaction wants v [B, F, E]");
  CheckF32(v, "v", v);
  const int64_t batch = v.size(0), fields = v.size(1), emb = v.size(2);
  TORCH_CHECK(batch < (1LL << 31) && fields * emb < (1LL << 31),
              "fm_interaction: shape exceeds the kernel's int32 indexing");
  if (v.numel() == 0) return at::zeros({batch}, v.options());
  at::Tensor out = at::empty({batch}, v.options());
  const c10::cuda::CUDAGuard guard(v.device());
  const int err = fm_fwd(v.data_ptr<float>(), out.data_ptr<float>(), static_cast<int>(batch),
                         static_cast<int>(fields), static_cast<int>(emb),
                         c10::cuda::getCurrentCUDAStream(v.device().index()).stream());
  TORCH_CHECK(err == 0, "fm_fwd kernel launch failed: ", fm_error_string(err));
  ++g_launches[1];
  return out;
}

at::Tensor DinCuda(const at::Tensor& his, const at::Tensor& tgt, const at::Tensor& valid,
                   at::TensorList params_list, c10::string_view activation_view) {
  const std::vector<at::Tensor> params = params_list.vec();
  const std::string activation(activation_view.data(), activation_view.size());
  CheckDin(his, tgt, valid, params, activation);
  const int64_t b = his.size(0), s = his.size(1), e = his.size(2), n = tgt.size(1);
  at::Tensor out = at::empty({b, n, e}, his.options());
  if (out.numel() == 0) return out;
  TORCH_CHECK(b < (1LL << 31) && n < (1LL << 31), "din_attention_pool: B, N exceed int32");
  const int layers = static_cast<int>(params.size() / 2);
  std::vector<int> dims, hidden;
  std::vector<const void*> weights, biases;
  for (int l = 0; l < layers; ++l) {
    dims.push_back(static_cast<int>(params[2 * l].size(0)));
    if (l > 0) hidden.push_back(dims.back());
    weights.push_back(params[2 * l].data_ptr());
    biases.push_back(params[2 * l + 1].data_ptr());
  }
  dims.push_back(1);
  const c10::cuda::CUDAGuard guard(his.device());
  const int device = his.device().index();
  const long long limit = DeviceAttribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const long long rows = plans::PlanDinRows(static_cast<int>(e), static_cast<int>(s), hidden,
                                            limit);
  TORCH_CHECK(rows >= 1, "din_attention_pool kernel: no tile fits E=", e, ", S=", s,
              " in the device's ", limit, " B of shared memory a block, or the shape is past ",
              "the kernel's limits");
  const int err = din_attention_fwd(
      his.data_ptr<float>(), tgt.data_ptr<float>(), valid.data_ptr<int>(), weights.data(),
      biases.data(), dims.data(), layers, out.data_ptr<float>(), static_cast<int>(b),
      static_cast<int>(n), static_cast<int>(s), static_cast<int>(e),
      activation == "sigmoid" ? 0 : 1, static_cast<int>(rows),
      c10::cuda::getCurrentCUDAStream(device).stream());
  TORCH_CHECK(err == 0, "din_attention_pool kernel launch failed: ",
              din_attention_error_string(err));
  ++g_launches[2];
  return out;
}

#endif  // SERVING_OPS_CUDA

}  // namespace

TORCH_LIBRARY(pytorchrec, m) {
  m.def("cross_network(Tensor x0, Tensor ws, Tensor bs) -> Tensor");
  m.def("fm_interaction(Tensor v) -> Tensor");
  m.def("din_attention_pool(Tensor his, Tensor tgt, Tensor valid, Tensor[] params, str activation) -> Tensor");
}

TORCH_LIBRARY_IMPL(pytorchrec, CPU, m) {
  m.impl("cross_network", &CrossCpu);
  m.impl("fm_interaction", &FmCpu);
  m.impl("din_attention_pool", &DinCpu);
}

#ifdef SERVING_OPS_CUDA
TORCH_LIBRARY_IMPL(pytorchrec, CUDA, m) {
  m.impl("cross_network", &CrossCuda);
  m.impl("fm_interaction", &FmCuda);
  m.impl("din_attention_pool", &DinCuda);
}
#endif

extern "C" {

// The kernel launches of op `name` since the library was loaded (the CPU
// versions launch nothing), or -1 for a name that is not an op here.
long long pytorchrec_serving_launches(const char* name) {
  for (int i = 0; i < 3; ++i)
    if (std::strcmp(name, kOps[i]) == 0) return g_launches[i].load();
  return -1;
}

}  // extern "C"
