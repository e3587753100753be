// Flash-attention kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes, see kernels/build.py and kernels/flash_attention/kernel.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention/kernel.py:
//   flash_decode          (kernel.py:63, body _decode_kernel :35)
//   flash_prefill_causal  (kernel.py:145, body _prefill_kernel :108)
//
// Both compute softmax(q k^T / sqrt(D)) v with float32 scores, an online
// softmax and float32 accumulators, for float32 or bf16 inputs; the output
// has q's dtype.  Query head h reads KV head h / (Hq / Hk) (GQA and MQA)
// with no copy of the cache.
//
// Bounds on the H100 SXM (NVIDIA data sheet: 3.35 TB/s, 67 TFLOP/s fp32
// outside the tensor cores, 989 TFLOP/s bf16 tensor cores):
//   * decode is bound by bytes: K and V are read once per KV head, 2.15 GB
//     in bf16 at each decode_32k shape of the repo's LM configurations,
//     0.642 ms.  At granite-34b's MQA (48 query heads on one KV head) the
//     products are 103 GFLOP, 1.54 ms on fp32 CUDA cores: that kernel is
//     bound by operations, as this one runs them.
//   * causal prefill is bound by operations: 206 GFLOP at granite-34b's
//     width and T = 4096, 0.209 ms on bf16 tensor cores, 3.08 ms on fp32
//     CUDA cores.
// Both kernels here run fp32 FMA on CUDA cores, in both dtypes: the
// float32 tolerance (2e-5) rules out TF32, and tensor-core versions
// (mma.sync / wgmma with TMA) are later work.
//
// Design.  Both kernels share one tile engine: a block of 256 threads
// holds up to 64 query rows and walks key tiles of 64, staged in shared
// memory as float32.  Thread (tg, tk) = (tid / 16, tid % 16) owns rows
// tg + 16 i (i < 4) and, for the scores, keys tk + 16 j (j < 4), so each
// 4-wide step over D reads 4 K and 4 q vectors from shared memory for 64
// FMAs; row maxima and sums reduce over the 16 lanes of a half-warp with a
// fixed xor-shuffle tree.  For P V the same thread owns its rows and
// columns tk * 4 + 64 c, so its row statistics stay in registers.
//   * flash_decode is split-KV decoding.  One block owns one
//     (batch, KV head, S split): its rows are the group = Hq / Hk query
//     heads that share the KV head, so each K/V tile is read from device
//     memory once and applied to all of them (the TPU grid read it once per
//     query head).  The block writes unnormalised partials (m, l, acc[D])
//     in float32.  A second launch combines the splits of each query head
//     in split order: no atomics, so two runs are bitwise equal.  The
//     wrapper chooses the number of splits so that enough blocks fill the
//     card even at B * Hk = 1.  The block masks the ragged last tile, so
//     any S works.
//   * flash_prefill_causal runs one block per (batch, query head, 64-row
//     query tile).  It loops over the key tiles up to the diagonal only
//     (the TPU kernel's pl.when skip becomes a shorter loop), masks
//     k_pos > q_pos and the ragged T and S edges with -1e30, and clamps l
//     at 1e-30, as the reference does (top-left causal mask).  Blocks with
//     the most key tiles are numbered first, so they start first.
// Every sum runs in a fixed order; FMA contraction is the compiler's, the
// same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // query rows of a tile
constexpr int kKeys = 64;        // keys of a tile
constexpr int kLanes = 16;       // threads along keys (and columns) per row group
constexpr int kRowsPerThread = kRows / kLanes;  // 4
constexpr int kKeysPerThread = kKeys / kLanes;  // 4
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void to_float(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void to_float(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy `rows` rows of q (D contiguous elements each) into shared memory as
// float32 (row pitch `pitch`), times `scale`; rows at or past `valid` are
// zero, so no masked product ever meets an uninitialised value.
template <typename T, int D>
__device__ void load_tile(float* dst, int pitch, const T* src, int rows,
                          int valid, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int e = (c % kPerRow) * kVec;
    float x[kVec];
    if (r < valid) {
      to_float(src + static_cast<size_t>(r) * D + e, x);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      *reinterpret_cast<float4*>(dst + r * pitch + e + i) =
          make_float4(x[i] * scale, x[i + 1] * scale, x[i + 2] * scale,
                      x[i + 3] * scale);
    }
  }
}

// Copy N tiles of kKeys rows (D contiguous elements each) into shared
// memory as float32: every thread issues all its 16-byte loads of the N
// tiles before it converts and stores any, so the N tiles cost one memory
// latency.  Rows at or past `valid` are zero.
template <typename T, int D, int N>
__device__ void copy_tiles(float* const (&dst)[N], const int (&pitch)[N],
                           const T* const (&src)[N], int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kChunks = kKeys * kPerRow / kThreads;  // per thread and tile
  static_assert(kKeys * kPerRow % kThreads == 0, "tile must split evenly");
  uint4 raw[N][kChunks];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kPerRow, e = (c % kPerRow) * kVec;
      raw[n][i] = r < valid ? __ldg(reinterpret_cast<const uint4*>(
                                  src[n] + static_cast<size_t>(r) * D + e))
                            : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kPerRow, e = (c % kPerRow) * kVec;
      float x[kVec];
      to_float(reinterpret_cast<const T*>(&raw[n][i]), x);
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        *reinterpret_cast<float4*>(dst[n] + r * pitch[n] + e + j) =
            make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    }
}

// The K and V tiles at once, or K then V where holding both would take
// more than 8 loads (32 registers) a thread: float32 at D = 128.
template <typename T, int D>
__device__ void load_kv_tiles(float* ks, int k_pitch, float* vs, const T* k,
                              const T* v, int valid) {
  constexpr int kChunks = kKeys * D * sizeof(T) / 16 / kThreads;
  if constexpr (2 * kChunks <= 8) {
    copy_tiles<T, D, 2>({ks, vs}, {k_pitch, D}, {k, v}, valid);
  } else {
    copy_tiles<T, D, 1>({ks}, {k_pitch}, {k}, valid);
    copy_tiles<T, D, 1>({vs}, {D}, {v}, valid);
  }
}

template <int D>
struct Layout {
  static constexpr int kQPitch = D + 4;  // +4: conflict-free float4 reads
  static constexpr int kKPitch = D + 4;
  static constexpr int kPPitch = kKeys + 4;
  static constexpr int kCols = D / 64;   // float4 columns per thread in P V
  // q [rows][kQPitch], k [kKeys][kKPitch], v [kKeys][D], p [rows][kPPitch]
  static size_t bytes(int rows) {
    return sizeof(float) * (static_cast<size_t>(rows) * kQPitch +
                            kKeys * kKPitch + kKeys * D + rows * kPPitch);
  }
};

// The state of one block's rows: running max m, running sum l, and the
// unnormalised output acc, for the thread's rows tg + 16 i and columns
// tk * 4 + 64 c (+0..3).
template <int D>
struct RowState {
  float m[kRowsPerThread];
  float l[kRowsPerThread];
  float4 acc[kRowsPerThread][Layout<D>::kCols];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < Layout<D>::kCols; ++c) acc[i][c] = make_float4(0, 0, 0, 0);
    }
  }
};

// One key tile against the block's rows.  qs, ks, vs, ps are in shared
// memory, ks/vs already hold the tile (zero past its valid keys).
// `row_tiles` = ceil(rows / 16) bounds i.  Unless kAllRows, rows at or
// past `rows` skip the two products (a decode group of 4 leaves 6 of the 8
// warps idle there, free for other blocks), but still take part in the
// shuffles.  Prefill computes all 64 rows (kAllRows): its last tile's
// spare rows are never stored, and a test in the products costs more.
// mask(row, key) says whether the score is kept (key indices relative to
// the tile).  Ends with a __syncthreads, so the caller may overwrite ks/vs.
template <int D, bool kAllRows, typename Mask>
__device__ void attend_tile(RowState<D>& st, const float* qs, const float* ks,
                            const float* vs, float* ps, int rows, int row_tiles,
                            Mask mask) {
  using L = Layout<D>;
  const int tg = threadIdx.x / kLanes;
  const int tk = threadIdx.x % kLanes;

  // scores s[i][j] = q[tg + 16 i] . k[tk + 16 j]
  float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
  bool on[kRowsPerThread];  // rows of this thread that are kept
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) on[i] = kAllRows || (i < row_tiles && tg + kLanes * i < rows);
  if (on[0]) {
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kk[kKeysPerThread];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kk[j] = *reinterpret_cast<const float4*>(ks + (tk + kLanes * j) * L::kKPitch + d);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (on[i]) {
          const float4 qq = *reinterpret_cast<const float4*>(qs + (tg + kLanes * i) * L::kQPitch + d);
#pragma unroll
          for (int j = 0; j < kKeysPerThread; ++j) {
            s[i][j] = fmaf(qq.x, kk[j].x, s[i][j]);
            s[i][j] = fmaf(qq.y, kk[j].y, s[i][j]);
            s[i][j] = fmaf(qq.z, kk[j].z, s[i][j]);
            s[i][j] = fmaf(qq.w, kk[j].w, s[i][j]);
          }
        }
      }
    }
  }

  // online softmax over the tile; the 16 lanes of a row group hold its keys
  float alpha[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    alpha[i] = 1.f;
    if (i >= row_tiles) continue;  // uniform across the block
    const int row = tg + kLanes * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (!mask(row, tk + kLanes * j)) s[i][j] = kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const float p = expf(s[i][j] - m_new);
      ps[row * L::kPPitch + tk + kLanes * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    alpha[i] = expf(st.m[i] - m_new);
    st.l[i] = st.l[i] * alpha[i] + sum;
    st.m[i] = m_new;
  }
  __syncthreads();

  // acc[row][col] = acc * alpha + sum_t p[row][t] v[t][col]
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) {
      float4& a = st.acc[i][c];
      a.x *= alpha[i]; a.y *= alpha[i]; a.z *= alpha[i]; a.w *= alpha[i];
    }
  if (on[0]) {
#pragma unroll 4
    for (int t = 0; t < kKeys; ++t) {
      float4 vv[L::kCols];
#pragma unroll
      for (int c = 0; c < L::kCols; ++c)
        vv[c] = *reinterpret_cast<const float4*>(vs + t * D + tk * 4 + 64 * c);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (on[i]) {
          const float p = ps[(tg + kLanes * i) * L::kPPitch + t];
#pragma unroll
          for (int c = 0; c < L::kCols; ++c) {
            float4& a = st.acc[i][c];
            a.x = fmaf(p, vv[c].x, a.x);
            a.y = fmaf(p, vv[c].y, a.y);
            a.z = fmaf(p, vv[c].z, a.z);
            a.w = fmaf(p, vv[c].w, a.w);
          }
        }
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- decode
// grid (splits, B * Hk, ceil(group / 64)); partials for query head h of
// batch b and split sp at ((b * Hq + h) * splits + sp): m, l, then acc[D]
// in a separate array.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ part_ml,
             float* __restrict__ part_acc, int Hq, int Hk, int S,
             int keys_per_split, float scale) {
  using L = Layout<D>;
  extern __shared__ float4 smem4[];
  const int group = Hq / Hk;
  const int sp = blockIdx.x, splits = gridDim.x;
  const int b = blockIdx.y / Hk, kvh = blockIdx.y % Hk;
  const int g0 = blockIdx.z * kRows;
  const int rows = min(kRows, group - g0);
  const int row_tiles = (rows + kLanes - 1) / kLanes;
  const int rows_alloc = row_tiles * kLanes;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + rows_alloc * L::kQPitch;
  float* vs = ks + kKeys * L::kKPitch;
  float* ps = vs + kKeys * D;

  const int h0 = kvh * group + g0;  // first query head of the block
  load_tile<T, D>(qs, L::kQPitch, q + (static_cast<size_t>(b) * Hq + h0) * D,
                  rows_alloc, rows, scale);
  const size_t kv_off = (static_cast<size_t>(b) * Hk + kvh) * S;
  const int key_begin = sp * keys_per_split;
  const int key_end = min(S, key_begin + keys_per_split);

  RowState<D> st;
  st.init();
  for (int t0 = key_begin; t0 < key_end; t0 += kKeys) {
    const int valid = min(kKeys, key_end - t0);
    load_kv_tiles<T, D>(ks, L::kKPitch, vs, k + (kv_off + t0) * D,
                        v + (kv_off + t0) * D, valid);
    __syncthreads();
    attend_tile<D, false>(st, qs, ks, vs, ps, rows, row_tiles,
                   [valid](int, int key) { return key < valid; });
  }

  const int tg = threadIdx.x / kLanes, tk = threadIdx.x % kLanes;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = tg + kLanes * i;
    if (row >= rows) continue;
    const size_t slot = (static_cast<size_t>(b) * Hq + h0 + row) * splits + sp;
    if (tk == 0) {
      part_ml[2 * slot] = st.m[i];
      part_ml[2 * slot + 1] = st.l[i];
    }
#pragma unroll
    for (int c = 0; c < L::kCols; ++c)
      *reinterpret_cast<float4*>(part_acc + slot * D + tk * 4 + 64 * c) = st.acc[i][c];
  }
}

// grid (B * Hq), D threads: out[bh][d] = sum_sp w_sp acc_sp[d] / sum_sp w_sp l_sp
// with w_sp = exp(m_sp - max m), the splits taken in order.
template <typename T>
__global__ void decode_combine(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int splits, int D) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * bh * splits;
  float mx = kNegInf;
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, ml[2 * sp]);
  float num = 0.f, den = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float w = expf(ml[2 * sp] - mx);
    den = fmaf(w, ml[2 * sp + 1], den);
    num = fmaf(w, part_acc[(bh * splits + sp) * D + d], num);
  }
  store(out + bh * D + d, num / den);
}

// ---------------------------------------------------------------- prefill
// grid (B * Hq, ceil(T / 64)); blockIdx.y = 0 takes the last query tile,
// the one with the most key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_causal(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, int Hq, int Hk,
               int Tq, int S, float scale) {
  using L = Layout<D>;
  extern __shared__ float4 smem4[];
  const int group = Hq / Hk;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = q_tile * kRows;
  const int rows = min(kRows, Tq - q0);
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * L::kQPitch;
  float* vs = ks + kKeys * L::kKPitch;
  float* ps = vs + kKeys * D;

  const size_t q_off = (static_cast<size_t>(b) * Hq + h) * Tq + q0;
  load_tile<T, D>(qs, L::kQPitch, q + q_off * D, kRows, rows, scale);
  const size_t kv_off = (static_cast<size_t>(b) * Hk + h / group) * S;
  // keys up to the tile's last query row (top-left causal), within S
  const int key_end = min(S, q0 + rows);

  RowState<D> st;
  st.init();
  for (int t0 = 0; t0 < key_end; t0 += kKeys) {
    const int valid = min(kKeys, S - t0);
    load_kv_tiles<T, D>(ks, L::kKPitch, vs, k + (kv_off + t0) * D,
                        v + (kv_off + t0) * D, valid);
    __syncthreads();
    const int diag = q0 - t0;  // key index (in the tile) of row 0's position
    attend_tile<D, true>(st, qs, ks, vs, ps, kRows, kRowsPerThread,
                   [valid, diag](int row, int key) {
                     return key < valid && key <= row + diag;
                   });
  }

  const int tg = threadIdx.x / kLanes, tk = threadIdx.x % kLanes;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = tg + kLanes * i;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
    T* o = out + (q_off + row) * D;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) {
      const float4 a = st.acc[i][c];
      const int col = tk * 4 + 64 * c;
      store(o + col, a.x * inv);
      store(o + col + 1, a.y * inv);
      store(o + col + 2, a.z * inv);
      store(o + col + 3, a.w * inv);
    }
  }
}

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: select the tensors' device before launching on its stream.
template <typename K>
cudaError_t prepare(K kernel, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
int launch_decode_split(const T* q, const T* k, const T* v, float* part_ml,
                        float* part_acc, int B, int Hq, int Hk, int S,
                        int splits, int keys_per_split, float scale, int device,
                        cudaStream_t stream) {
  const int group = Hq / Hk;
  const int rows_alloc = ((min(group, kRows) + kLanes - 1) / kLanes) * kLanes;
  const size_t smem = Layout<D>::bytes(rows_alloc);
  auto kernel = decode_split<T, D>;
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, B * Hk, (group + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, part_ml, part_acc, Hq, Hk, S,
                                           keys_per_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_prefill(const T* q, const T* k, const T* v, T* out, int B, int Hq,
                   int Hk, int Tq, int S, float scale, int device,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes(kRows);
  auto kernel = prefill_causal<T, D>;
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (Tq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, Hq, Hk, Tq, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int decode_split_dispatch(const T* q, const T* k, const T* v, float* part_ml,
                          float* part_acc, int B, int Hq, int Hk, int S, int D,
                          int splits, int keys_per_split, float scale,
                          int device, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_decode_split<T, 64>(q, k, v, part_ml, part_acc, B, Hq, Hk, S,
                                        splits, keys_per_split, scale, device, s);
    case 128:
      return launch_decode_split<T, 128>(q, k, v, part_ml, part_acc, B, Hq, Hk, S,
                                         splits, keys_per_split, scale, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int decode_combine_launch(const float* part_ml, const float* part_acc, T* out,
                          int BH, int splits, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<T><<<BH, D, 0, static_cast<cudaStream_t>(stream)>>>(
      part_ml, part_acc, out, splits, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int prefill_dispatch(const T* q, const T* k, const T* v, T* out, int B, int Hq,
                     int Hk, int Tq, int S, int D, float scale, int device,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_prefill<T, 64>(q, k, v, out, B, Hq, Hk, Tq, S, scale, device, s);
    case 128:
      return launch_prefill<T, 128>(q, k, v, out, B, Hq, Hk, Tq, S, scale, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Split pass: q [B, Hq, D], K/V [B, Hk, S, D]; part_ml [B*Hq, splits, 2]
// and part_acc [B*Hq, splits, D] in float32.  Split sp covers keys
// [sp * keys_per_split, min(S, (sp + 1) * keys_per_split)); every split
// must hold at least one key.
int flash_decode_split_f32(const float* q, const float* k, const float* v,
                           float* part_ml, float* part_acc, int B, int Hq, int Hk,
                           int S, int D, int splits, int keys_per_split,
                           float scale, int device, void* stream) {
  return decode_split_dispatch<float>(q, k, v, part_ml, part_acc, B, Hq, Hk, S, D,
                                      splits, keys_per_split, scale, device, stream);
}

int flash_decode_split_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, float* part_ml,
                            float* part_acc, int B, int Hq, int Hk, int S, int D,
                            int splits, int keys_per_split, float scale,
                            int device, void* stream) {
  return decode_split_dispatch<__nv_bfloat16>(q, k, v, part_ml, part_acc, B, Hq, Hk,
                                              S, D, splits, keys_per_split, scale,
                                              device, stream);
}

// Combine pass: the partials above -> out [B, Hq, D] (BH = B * Hq).
int flash_decode_combine_f32(const float* part_ml, const float* part_acc,
                             float* out, int BH, int splits, int D, int device,
                             void* stream) {
  return decode_combine_launch<float>(part_ml, part_acc, out, BH, splits, D, device,
                                      stream);
}

int flash_decode_combine_bf16(const float* part_ml, const float* part_acc,
                              __nv_bfloat16* out, int BH, int splits, int D,
                              int device, void* stream) {
  return decode_combine_launch<__nv_bfloat16>(part_ml, part_acc, out, BH, splits, D,
                                              device, stream);
}

// Causal prefill: q [B, Hq, T, D], K/V [B, Hk, S, D] -> out [B, Hq, T, D].
int flash_prefill_causal_f32(const float* q, const float* k, const float* v,
                             float* out, int B, int Hq, int Hk, int T, int S,
                             int D, float scale, int device, void* stream) {
  return prefill_dispatch<float>(q, k, v, out, B, Hq, Hk, T, S, D, scale, device,
                                 stream);
}

int flash_prefill_causal_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* out, int B,
                              int Hq, int Hk, int T, int S, int D, float scale,
                              int device, void* stream) {
  return prefill_dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hk, T, S, D, scale,
                                         device, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
