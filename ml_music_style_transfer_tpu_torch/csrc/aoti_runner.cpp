// Run one AOTInductor package with no Python in the process.
//
//   aoti_runner PACKAGE.pt2 INPUTS.pt OUTPUT.pt [RUNS]
//
// PACKAGE.pt2 is a package written by compat/program_export.py
// (write_packages, torch._inductor.aoti_compile_and_package). INPUTS.pt holds
// the program's inputs flattened in its call order (parameters first, in the
// model's order, then the rest), as a list of tensors written by torch.save;
// the runner moves them to the package's device, but those the package's
// metadata lists under mmst_host_inputs (flat indices, comma-separated: the
// iteration count), which stay on the host. It runs the package RUNS
// times (default 1) on them and writes the last run's outputs as a tuple of
// CPU tensors, which torch.load reads.
//
// The operator library libmmst_ops.so is linked in (found by the rpath),
// so the mmst_torch operators the package calls are registered before the
// package loads; their launch counters are read through its C interface.
// Float32 convolutions and matmuls run without TF32, as the package's float32
// program computes. It prints one JSON line: the device, the seconds to load the package and
// to run it each time (each run ended by a device synchronisation), and per
// operator entry the CUDA launches and CPU calls of each run.
#include <ATen/Context.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/csrc/jit/serialization/pickle.h>
#include <torch/cuda.h>

#include <chrono>
#include <cstdio>
#include <fstream>
#include <iostream>
#include <iterator>
#include <set>
#include <sstream>
#include <string>
#include <vector>

extern "C" long long mmst_launch_count(const char* op, const char* device);
extern "C" int mmst_launch_entries(const char* const** names);

namespace {

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
}

std::vector<char> read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot read " + path);
  return std::vector<char>(std::istreambuf_iterator<char>(f), std::istreambuf_iterator<char>());
}

void write_file(const std::string& path, const std::vector<char>& data) {
  std::ofstream f(path, std::ios::binary);
  f.write(data.data(), static_cast<std::streamsize>(data.size()));
  if (!f) throw std::runtime_error("cannot write " + path);
}

std::vector<long long> counts(const char* device) {
  const char* const* names;
  const int n = mmst_launch_entries(&names);
  std::vector<long long> out;
  for (int e = 0; e < n; ++e) out.push_back(mmst_launch_count(names[e], device));
  return out;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4 || argc > 5) {
    std::cerr << "usage: " << argv[0] << " PACKAGE.pt2 INPUTS.pt OUTPUT.pt [RUNS]\n";
    return 2;
  }
  const int runs = argc == 5 ? std::stoi(argv[4]) : 1;
  try {
    at::globalContext().setAllowTF32CuDNN(false);
    at::globalContext().setAllowTF32CuBLAS(false);
    c10::InferenceMode guard;
    auto t0 = std::chrono::steady_clock::now();
    torch::inductor::AOTIModelPackageLoader loader(argv[1]);
    const double load_s = seconds_since(t0);
    auto metadata = loader.get_metadata();
    const std::string device = metadata["AOTI_DEVICE_KEY"];
    const bool cuda = device == "cuda";
    std::set<size_t> host;
    std::istringstream host_list(metadata["mmst_host_inputs"]);
    for (std::string i; std::getline(host_list, i, ',');) {
      if (!i.empty()) host.insert(std::stoul(i));
    }

    std::vector<at::Tensor> inputs;
    const c10::IValue saved_inputs = torch::jit::pickle_load(read_file(argv[2]));
    for (const c10::IValue& v : saved_inputs.toListRef()) {
      const bool on_host = !cuda || host.count(inputs.size());
      inputs.push_back(v.toTensor().to(on_host ? at::Device(at::kCPU) : at::Device(at::kCUDA, 0)));
    }

    const char* const* names;
    const int n_entries = mmst_launch_entries(&names);
    std::vector<double> run_s;
    std::vector<std::vector<long long>> cuda_calls(n_entries), cpu_calls(n_entries);
    std::vector<at::Tensor> outputs;
    for (int r = 0; r < runs; ++r) {
      const auto cuda0 = counts("cuda"), cpu0 = counts("cpu");
      if (cuda) torch::cuda::synchronize();
      t0 = std::chrono::steady_clock::now();
      outputs = loader.run(inputs);
      if (cuda) torch::cuda::synchronize();
      run_s.push_back(seconds_since(t0));
      const auto cuda1 = counts("cuda"), cpu1 = counts("cpu");
      for (int e = 0; e < n_entries; ++e) {
        cuda_calls[e].push_back(cuda1[e] - cuda0[e]);
        cpu_calls[e].push_back(cpu1[e] - cpu0[e]);
      }
    }

    // a tuple (a list would carry a type tag that torch.load's weights_only
    // unpickler refuses)
    std::vector<c10::IValue> saved;
    for (const at::Tensor& t : outputs) saved.emplace_back(t.cpu());
    write_file(argv[3], torch::jit::pickle_save(c10::ivalue::Tuple::create(std::move(saved))));

    std::ostringstream js;
    js.precision(17);
    auto list = [&js](const auto& xs) {
      js << "[";
      for (size_t i = 0; i < xs.size(); ++i) js << (i ? ", " : "") << xs[i];
      js << "]";
    };
    js << "{\"device\": \"" << device << "\", \"load_s\": " << load_s << ", \"run_s\": ";
    list(run_s);
    js << ", \"launches\": {";
    for (int e = 0; e < n_entries; ++e) {
      js << (e ? ", " : "") << "\"" << names[e] << "\": {\"cuda\": ";
      list(cuda_calls[e]);
      js << ", \"cpu\": ";
      list(cpu_calls[e]);
      js << "}";
    }
    js << "}}";
    std::cout << js.str() << std::endl;
  } catch (const std::exception& e) {
    std::cerr << "aoti_runner: " << e.what() << "\n";
    return 1;
  }
  return 0;
}
