// aoti_serve: Python-free scoring of a serving bundle
// (pytorchrec_tpu_torch/serving/bundle.py::export_serving_bundle).
//
// Loads the bundle's ops library (csrc/serving_ops.cpp: the pytorchrec
// operators, which launch the hand-written kernels on CUDA tensors), loads
// the AOTInductor package with AOTIModelPackageLoader, copies the inputs to
// the package's device, runs once and compares with the expected scores
// recorded at export, then times more runs. No Python interpreter: a
// deployment needs this binary, libtorch and the bundle directory.
//
// The manifest (manifest.txt), one line each:
//
//   program model.pt2                       the AOTInductor package
//   ops_library serving_ops.so              the operators' library
//   input i32 4096 input_0.bin c_0          dtype, dims (csv), file, batch key
//   expected f32 4096 expected_0.bin        dtype, dims, file
//   op cross_network 1                      kernel launches a request makes
//   tolerance 0.0001                        max |score - expected|
//
// Build: ops/kernels/build.py::server_binary (serving/bundle.py's
// shim_binary_path), g++ against the torch wheel's headers and libraries.
// Run:   aoti_serve <bundle_dir> [--reps N] [--dry]
//
// --dry parses the manifest and checks every tensor file's size against its
// dtype and dims, and that the program and the library exist; it loads
// nothing and needs no device. Otherwise the run ends non-zero on anything
// wrong: a missing op or library, a corrupt file, scores out of tolerance, a
// launch count that is not (1 + N) times the manifest's count a request.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <dlfcn.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

[[noreturn]] void Die(const std::string& msg) {
  std::fprintf(stderr, "aoti_serve: FATAL: %s\n", msg.c_str());
  std::exit(1);
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

bool Exists(const std::string& path) { return std::ifstream(path).good(); }

// ------------------------------------------------------------------ manifest

struct TensorSpec {
  std::string dtype;  // f32 | f64 | i32 | i64 | u32 | i8 | u8
  std::vector<int64_t> dims;
  std::string file;  // relative to the bundle dir
  std::string name;  // the batch key (inputs only)
};

struct Manifest {
  std::string program;
  std::string ops_library;
  std::vector<TensorSpec> inputs;
  std::vector<TensorSpec> expected;
  std::vector<std::pair<std::string, long long>> ops;  // launches a request
  double tolerance = 1e-4;
};

std::vector<int64_t> ParseDims(const std::string& csv) {
  std::vector<int64_t> dims;
  if (csv == "scalar") return dims;
  std::stringstream ss(csv);
  std::string part;
  while (std::getline(ss, part, ',')) {
    try {
      dims.push_back(std::stoll(part));
    } catch (const std::exception&) {
      Die("bad dims " + csv);
    }
    if (dims.back() < 0) Die("bad dims " + csv);
  }
  return dims;
}

Manifest ParseManifest(const std::string& dir) {
  Manifest m;
  std::ifstream f(dir + "/manifest.txt");
  if (!f) Die("cannot open " + dir + "/manifest.txt");
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::stringstream ss(line);
    std::string kind;
    ss >> kind;
    if (kind == "program") {
      ss >> m.program;
    } else if (kind == "ops_library") {
      ss >> m.ops_library;
    } else if (kind == "input" || kind == "expected") {
      TensorSpec t;
      std::string dims;
      ss >> t.dtype >> dims >> t.file;
      ss >> t.name;  // inputs only
      if (t.file.empty()) Die("bad manifest line: " + line);
      t.dims = ParseDims(dims);
      (kind == "input" ? m.inputs : m.expected).push_back(t);
    } else if (kind == "op") {
      std::string name;
      long long per_request = -1;
      ss >> name >> per_request;
      if (name.empty() || per_request < 0) Die("bad manifest line: " + line);
      m.ops.emplace_back(name, per_request);
    } else if (kind == "tolerance") {
      if (!(ss >> m.tolerance) || !(m.tolerance >= 0)) Die("bad manifest line: " + line);
    } else {
      Die("unknown manifest line kind: " + kind);
    }
  }
  if (m.program.empty() || m.ops_library.empty()) Die("manifest missing program/ops_library");
  if (m.inputs.empty() || m.expected.empty()) Die("manifest has no input or no expected");
  return m;
}

at::ScalarType DtypeOf(const std::string& d) {
  if (d == "f32") return at::kFloat;
  if (d == "f64") return at::kDouble;
  if (d == "i32") return at::kInt;
  if (d == "i64") return at::kLong;
  if (d == "u32") return at::kUInt32;
  if (d == "i8") return at::kChar;
  if (d == "u8") return at::kByte;
  Die("unsupported dtype " + d);
}

size_t DtypeBytes(const std::string& d) {
  if (d == "f64" || d == "i64") return 8;
  if (d == "f32" || d == "i32" || d == "u32") return 4;
  if (d == "i8" || d == "u8") return 1;
  Die("unsupported dtype " + d);
}

size_t NumElements(const TensorSpec& t) {
  size_t n = 1;
  for (int64_t d : t.dims) n *= static_cast<size_t>(d);
  return n;
}

std::string ReadTensorFile(const std::string& dir, const std::string& what, const TensorSpec& t) {
  std::string data = ReadFile(dir + "/" + t.file);
  if (data.size() != NumElements(t) * DtypeBytes(t.dtype))
    Die(what + " " + t.file + " size mismatch: " + std::to_string(data.size()) + " bytes, want " +
        std::to_string(NumElements(t) * DtypeBytes(t.dtype)));
  return data;
}

at::Tensor ToTensor(const TensorSpec& t, const std::string& data) {
  at::Tensor out = at::empty(t.dims, at::TensorOptions().dtype(DtypeOf(t.dtype)));
  std::memcpy(out.data_ptr(), data.data(), data.size());
  return out;
}

double Percentile(const std::vector<double>& sorted, double q) {
  const size_t n = sorted.size();
  const size_t rank = static_cast<size_t>(std::ceil(q * n));
  return sorted[std::min(n - 1, rank == 0 ? 0 : rank - 1)];
}

int Serve(const std::string& dir, const Manifest& m, const std::vector<std::string>& input_data,
          const std::vector<std::string>& expected_data, int reps) {
  // the operators first: the package calls them through the dispatcher
  const std::string lib_path = dir + "/" + m.ops_library;
  void* lib = dlopen(lib_path.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (lib == nullptr) Die(std::string("cannot load the ops library: ") + dlerror());
  using LaunchesFn = long long (*)(const char*);
  auto launches = reinterpret_cast<LaunchesFn>(dlsym(lib, "pytorchrec_serving_launches"));
  if (launches == nullptr) Die("the ops library has no pytorchrec_serving_launches");
  for (const auto& op : m.ops)
    if (launches(op.first.c_str()) < 0) Die("the ops library has no op " + op.first);
  std::vector<long long> before;
  for (const auto& op : m.ops) before.push_back(launches(op.first.c_str()));

  const auto t_load = std::chrono::steady_clock::now();
  torch::inductor::AOTIModelPackageLoader loader(dir + "/" + m.program);
  auto metadata = loader.get_metadata();
  const auto device_key = metadata.find("AOTI_DEVICE_KEY");
  if (device_key == metadata.end()) Die("the package names no device (AOTI_DEVICE_KEY)");
  const c10::Device device(device_key->second);
  const bool cuda = device.is_cuda();
  std::printf("package: %s on %s, loaded in %.1f ms\n", m.program.c_str(),
              device_key->second.c_str(),
              std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t_load)
                  .count());

  std::vector<at::Tensor> inputs;
  for (size_t i = 0; i < m.inputs.size(); ++i)
    inputs.push_back(ToTensor(m.inputs[i], input_data[i]).to(device));
  auto sync = [&] {
    if (cuda) torch::cuda::synchronize();
  };
  sync();

  // one run, compared with the expected scores
  std::vector<at::Tensor> outputs = loader.run(inputs);
  sync();
  if (outputs.size() != m.expected.size())
    Die("the package gives " + std::to_string(outputs.size()) + " outputs, the manifest lists " +
        std::to_string(m.expected.size()));
  bool all_ok = true;
  double worst = 0.0;
  for (size_t i = 0; i < outputs.size(); ++i) {
    const TensorSpec& t = m.expected[i];
    if (t.dtype != "f32") Die("verification only implemented for f32 outputs");
    const at::Tensor got = outputs[i].to(at::kCPU).contiguous();
    if (got.scalar_type() != at::kFloat || static_cast<size_t>(got.numel()) != NumElements(t))
      Die("output " + std::to_string(i) + " is not f32 of the expected size");
    const float* g = got.data_ptr<float>();
    const float* w = reinterpret_cast<const float*>(expected_data[i].data());
    double max_abs = 0.0;
    bool finite = true;
    for (size_t j = 0; j < NumElements(t); ++j) {
      const double diff = std::fabs(double(g[j]) - double(w[j]));
      if (!(diff <= max_abs)) max_abs = std::isnan(diff) ? INFINITY : diff;
      finite = finite && std::isfinite(g[j]);
    }
    const bool ok = finite && max_abs <= m.tolerance;
    all_ok = all_ok && ok;
    worst = std::max(worst, max_abs);
    std::printf("output %zu: max|diff| = %.3g (tolerance %.3g) -> %s\n", i, max_abs, m.tolerance,
                ok ? "MATCH" : "MISMATCH");
  }

  // N more runs, each followed by a sync: host clock
  std::vector<double> ms;
  for (int r = 0; r < reps; ++r) {
    const auto t0 = std::chrono::steady_clock::now();
    outputs = loader.run(inputs);
    sync();
    ms.push_back(
        std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0).count());
  }
  outputs.clear();
  std::sort(ms.begin(), ms.end());
  if (!ms.empty())
    std::printf("latency over %d runs: median %.4f ms, p90 %.4f ms, min %.4f ms, max %.4f ms\n",
                reps, Percentile(ms, 0.5), Percentile(ms, 0.9), ms.front(), ms.back());

  std::string counts;
  for (size_t i = 0; i < m.ops.size(); ++i) {
    const auto& op = m.ops[i];
    const long long got = launches(op.first.c_str()) - before[i];
    const long long want = (1LL + reps) * op.second;
    const bool ok = got == want;
    all_ok = all_ok && ok;
    std::printf("launches %s %lld (want %lld = %d runs x %lld) -> %s\n", op.first.c_str(), got,
                want, 1 + reps, op.second, ok ? "OK" : "WRONG");
    counts += (i ? ", \"" : "\"") + op.first + "\": " + std::to_string(got);
  }
  std::printf("RESULT {\"device\": \"%s\", \"runs\": %d, \"median_ms\": %.6f, \"p90_ms\": %.6f, "
              "\"max_abs_diff\": %.9g, \"launches\": {%s}}\n",
              device_key->second.c_str(), reps, ms.empty() ? 0.0 : Percentile(ms, 0.5),
              ms.empty() ? 0.0 : Percentile(ms, 0.9), worst, counts.c_str());
  std::printf("%s\n", all_ok ? "SERVING VERIFICATION PASSED" : "SERVING VERIFICATION FAILED");
  return all_ok ? 0 : 1;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <bundle_dir> [--reps N] [--dry]\n", argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  int reps = 10;
  bool dry = false;
  for (int i = 2; i < argc; ++i) {
    if (std::strcmp(argv[i], "--reps") == 0 && i + 1 < argc) {
      reps = std::atoi(argv[++i]);
      if (reps < 0) Die("--reps takes N >= 0");
    } else if (std::strcmp(argv[i], "--dry") == 0) {
      dry = true;
    } else {
      Die(std::string("unknown argument ") + argv[i]);
    }
  }

  const Manifest m = ParseManifest(dir);
  std::printf("bundle: %s\n  program: %s, ops library: %s (%zu inputs, %zu outputs)\n",
              dir.c_str(), m.program.c_str(), m.ops_library.c_str(), m.inputs.size(),
              m.expected.size());
  std::vector<std::string> input_data, expected_data;
  for (const auto& t : m.inputs) input_data.push_back(ReadTensorFile(dir, "input", t));
  for (const auto& t : m.expected) expected_data.push_back(ReadTensorFile(dir, "expected", t));
  if (!Exists(dir + "/" + m.program)) Die("missing program " + m.program);
  if (!Exists(dir + "/" + m.ops_library)) Die("missing ops library " + m.ops_library);
  if (dry) {
    std::printf("DRY OK: manifest + %zu input / %zu expected tensors parsed, %zu ops\n",
                m.inputs.size(), m.expected.size(), m.ops.size());
    return 0;
  }
  try {
    return Serve(dir, m, input_data, expected_data, reps);
  } catch (const std::exception& e) {
    Die(e.what());
  }
}
