// Bucketed-ELL push kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes, see kernels/build.py and kernels/spmv_ell/kernel.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/spmv_ell/kernel.py:
//   spmv_ell_bucket        (kernel.py:48, body _spmv_ell_kernel)
//   spmv_ell_bucket_batch  (kernel.py:89, body _spmv_ell_batch_kernel)
//
// Both compute, for one degree bucket,
//   out[b, r] = sum_j w[b, idx[r, j]]      j < k, w[b, n] == 0 (sentinel)
// for B operand rows (B == 1 for the single-vector kernel).
//
// Bound: bytes.  Each launch reads its index tile once (rows*k*4 bytes),
// gathers rows*k*B operand values and writes rows*B outputs, with one add
// per gathered value; at 3.35 TB/s against 34-67 TFLOP/s the adds never
// bind.  On the TPU the operand vector sat whole in VMEM; here it lives in
// device memory and the 50 MB L2 (7 MB in f64 at n = 875,713), so the
// gathers are L2 hits once warm and the index stream is what must move.
//
// Design:
//   * k <= 16: one thread owns one row, and sums its k gathers left to
//     right.  Neighbouring threads read neighbouring index rows.
//   * k > 16: one warp owns one row.  Lane l sums columns l, l+32, l+64, ...
//     in that order (coalesced index reads), then a fixed xor-shuffle tree
//     reduces the 32 lane sums.  No shared memory, no atomics.
//   * The batch kernel loads a row's indices into registers once (the first
//     128 columns; wider rows re-read the rest from L1/L2) and applies them
//     to all B operand rows, the point of the TPU batch kernel.
//   * Each operand row goes through exactly the same sequence of adds in
//     both kernels, so every row of the batch kernel is bitwise equal to
//     the single-vector kernel on that row.  Only adds are issued, so no
//     FMA contraction can change the rounding.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpSize = 32;
constexpr int kRowsPerBlock = kThreads / kWarpSize;
constexpr int kThreadRowMaxK = 16;  // widest row one thread owns
constexpr int kCachedPerLane = 4;   // first 4 * 32 = 128 columns in registers

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_per_thread(const T* __restrict__ w, long long ldw,
               const int* __restrict__ idx, T* __restrict__ out,
               long long ldo, int B, int rows, int k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int* row = idx + static_cast<size_t>(r) * k;
  int cols[kThreadRowMaxK];
#pragma unroll
  for (int j = 0; j < kThreadRowMaxK; ++j) cols[j] = j < k ? row[j] : 0;
  for (int b = 0; b < B; ++b) {
    const T* wb = w + static_cast<size_t>(b) * ldw;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kThreadRowMaxK; ++j) {
      if (j < k) acc += __ldg(wb + cols[j]);
    }
    out[static_cast<size_t>(b) * ldo + r] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_per_warp(const T* __restrict__ w, long long ldw,
             const int* __restrict__ idx, T* __restrict__ out,
             long long ldo, int B, int rows, int k) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  if (r >= rows) return;  // warp-uniform: the whole warp leaves together
  const int* row = idx + static_cast<size_t>(r) * k;
  int cols[kCachedPerLane];
#pragma unroll
  for (int t = 0; t < kCachedPerLane; ++t) {
    const int j = lane + t * kWarpSize;
    cols[t] = j < k ? row[j] : -1;
  }
  for (int b = 0; b < B; ++b) {
    const T* wb = w + static_cast<size_t>(b) * ldw;
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < kCachedPerLane; ++t) {
      if (cols[t] >= 0) acc += __ldg(wb + cols[t]);
    }
    for (int j = lane + kCachedPerLane * kWarpSize; j < k; j += kWarpSize) {
      acc += __ldg(wb + row[j]);
    }
#pragma unroll
    for (int off = kWarpSize / 2; off > 0; off /= 2) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[static_cast<size_t>(b) * ldo + r] = acc;
  }
}

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: select the tensors' device before launching on its stream.
template <typename T>
int launch(const T* w, long long ldw, const int* idx, T* out, long long ldo,
           int B, int rows, int k, int device, cudaStream_t stream) {
  if (rows <= 0 || B <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (k <= kThreadRowMaxK) {
    const int grid = (rows + kThreads - 1) / kThreads;
    row_per_thread<T><<<grid, kThreads, 0, stream>>>(w, ldw, idx, out, ldo,
                                                     B, rows, k);
  } else {
    const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    row_per_warp<T><<<grid, kThreads, 0, stream>>>(w, ldw, idx, out, ldo, B,
                                                   rows, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Single-vector kernel: w [n+1], idx int32 [rows, k], out [rows].
int spmv_ell_bucket_f32(const float* w, const int* idx, float* out, int rows,
                        int k, int device, void* stream) {
  return launch<float>(w, 0, idx, out, 0, 1, rows, k, device,
                       static_cast<cudaStream_t>(stream));
}

int spmv_ell_bucket_f64(const double* w, const int* idx, double* out,
                        int rows, int k, int device, void* stream) {
  return launch<double>(w, 0, idx, out, 0, 1, rows, k, device,
                        static_cast<cudaStream_t>(stream));
}

// Batch kernel: W [B, ldw] (row b's sentinel at W[b, n]), idx int32
// [rows, k], out [B, rows].
int spmv_ell_bucket_batch_f32(const float* w, long long ldw, const int* idx,
                              float* out, int B, int rows, int k, int device,
                              void* stream) {
  return launch<float>(w, ldw, idx, out, rows, B, rows, k, device,
                       static_cast<cudaStream_t>(stream));
}

int spmv_ell_bucket_batch_f64(const double* w, long long ldw, const int* idx,
                              double* out, int B, int rows, int k, int device,
                              void* stream) {
  return launch<double>(w, ldw, idx, out, rows, B, rows, k, device,
                        static_cast<cudaStream_t>(stream));
}

const char* spmv_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
