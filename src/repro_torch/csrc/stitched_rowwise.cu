// The row-wise hand-written kernels of repro_torch.kernels: softmax,
// RMSNorm and the MoE router gate, each one pass over its rows with the
// reduction kept on chip.
//
// stitched_softmax replaces repro/kernels/stitched_softmax.py
//   stitched_softmax (_softmax_kernel).
//   Bound by bytes: a handful of f32 operations per element.  Wide rows
//   (4,096 to 131,072 columns, the sampler's vocab rows) take
//   sx_softmax_cluster_kernel: a thread-block cluster of 8 blocks owns a
//   row, so 16 rows fill 128 of the 132 SMs.  Each block reads its slice
//   of the row once, into registers (EPT values a thread, coalesced 4- or
//   2-byte loads, so a row may start at any element), and forms the
//   slice's max m_b and e = exp(x - m_b), kept in the registers, and sum s_b
//   of e.  The 8 pairs go through distributed shared memory
//   (cluster.map_shared_rank, one 8-byte read a peer); every block merges
//   them into m = max m_b and s = sum s_b exp(m_b - m), where a slice that
//   is wholly -inf (m_b = -inf, s_b = NaN) adds 0, and writes
//   exp(x - m) / s as e * (exp(m_b - m) / s): one exp and one multiply an
//   element in all.  A row that holds a NaN or +inf, or only -inf,
//   stays NaN across, as in the reference.  Narrower rows, rows past what
//   the cluster holds and an explicit block_rows take sx_softmax_kernel: a
//   group of 32..1024 threads owns a row and walks it with a block stride,
//   the row's max and sum are f32 warp-shuffle reductions merged across
//   the group's warps in shared memory, x is read in the max, sum and
//   write passes, and a block holds `rows_per_block` rows so narrow rows
//   still fill whole warps.  The wrapper chooses before the launch.
//
// stitched_rmsnorm replaces repro/kernels/stitched_rmsnorm.py
//   stitched_rmsnorm (_rmsnorm_kernel).
//   Bound by bytes: x read once, y written once, four f32 operations per
//   element.  sx_rmsnorm_vec_kernel moves 16 bytes a thread (8 bf16 or f16,
//   or 4 f32) and holds its share of the row in registers, VPL <= 8 vectors a
//   lane, between the sum of squares and the write, so x is read once.  A
//   group of 1..8 warps owns a row (at d = 1536 bf16 one warp, 6 vectors a
//   lane; wider rows merge the group's sums in shared memory).  The grid is
//   as many 256-thread blocks as fit on the card at once; their row groups
//   stride over the rows and load their share of gamma once, into
//   registers.  y = (x * inv) * gamma with inv = 1 / sqrtf(ms + eps), one
//   rounding to the output type.  Rows that 16-byte accesses cannot serve
//   (d * itemsize not a multiple of 16, x or gamma not 16-byte aligned) or
//   cannot hold (more than 32 KB) take sx_rmsnorm_kernel, the row layout of
//   softmax, which reads x twice; the wrapper chooses before the launch.
//
// stitched_moe_gate replaces repro/kernels/stitched_moe_gate.py
//   stitched_moe_gate (_gate_kernel).
//   Bound by bytes (E logits in, 2k values out per token: 0.92 MB at 4096
//   x 40 f32, top-8), which few instructions per token reach.  A warp owns
//   a token and 8 warps make a block, so 4096 tokens make 512 blocks; a
//   tail of T that leaves a block short is guarded.  Its lanes hold the E
//   <= 256 logits in SLOTS = ceil(E / 32) rounded up to 1, 2, 4 or 8
//   registers, a template parameter, so at E = 40 each loop runs 2 slots.
//   Softmax by shuffles (accurate expf, each lane's slots summed in order,
//   then the butterfly), then top_k argmax rounds.  Each probability is
//   mapped to an unsigned key in the argmax's order (NaN above every
//   number, -0 equal to +0), so a round is one redux.sync max of the keys
//   and a ballot per slot until one holds that key, whose lowest lane
//   (__ffs) is the lowest expert index: ties go to the lower index.  The
//   pick is lowered by 2.0 as the Pallas kernel does (a NaN stays NaN and
//   is picked again), and the k weights are divided by their sum, added in
//   pick order.
//
// Each launcher is extern "C", one per element type (f32, bf16, f16: the
// 2-byte types read and write their own type and compute in f32), and returns
// cudaGetLastError() so a refused launch reaches the Python wrapper.

#include <cooperative_groups.h>

#include <atomic>

#include "hand_kernels.cuh"

// ---------------------------------------------------------------- softmax
template <typename T>
__global__ void __launch_bounds__(1024) sx_softmax_kernel(
    const T* __restrict__ x, T* __restrict__ y, int cols, int rows_per_block) {
  __shared__ float red[32];
  const int group = blockDim.x / rows_per_block;
  const int t = threadIdx.x % group;
  const long long row = (long long)blockIdx.x * rows_per_block + threadIdx.x / group;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  float m = sx_lowest<float>();
  for (int c = t; c < cols; c += group) m = sx_max(m, sx_load(xr + c));
  m = sx_group_reduce(m, group, red, SxMax());
  float s = 0.0f;
  for (int c = t; c < cols; c += group) s += expf(sx_load(xr + c) - m);
  s = sx_group_reduce(s, group, red, SxSum());
  for (int c = t; c < cols; c += group) sx_store(yr + c, expf(sx_load(xr + c) - m) / s);
}

template <typename T>
static int sx_softmax_launch(const T* x, T* y, int rows, int cols, int rows_per_block,
                             int threads, void* stream) {
  sx_softmax_kernel<T><<<rows / rows_per_block, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, cols, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sx_softmax_f32(const float* x, float* y, int rows, int cols,
                              int rows_per_block, int threads, void* stream) {
  return sx_softmax_launch(x, y, rows, cols, rows_per_block, threads, stream);
}

extern "C" int sx_softmax_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int rows, int cols,
                               int rows_per_block, int threads, void* stream) {
  return sx_softmax_launch(x, y, rows, cols, rows_per_block, threads, stream);
}

extern "C" int sx_softmax_f16(const __half* x, __half* y, int rows, int cols,
                               int rows_per_block, int threads, void* stream) {
  return sx_softmax_launch(x, y, rows, cols, rows_per_block, threads, stream);
}

// The cluster kernel: SX_SOFTMAX_CLUSTER_THREADS threads a block, a
// cluster of gridDim.x / rows blocks a row (the launch's cluster
// dimension), block `rank` of the cluster owning columns [rank * slice,
// rank * slice + slice).  EPT >= slice / threads values a thread.
constexpr int SX_SOFTMAX_CLUSTER_THREADS = 512;
constexpr int SX_SOFTMAX_MAX_CLUSTER = 8;  // the portable cluster size
constexpr int kSxDevices = 16;  // devices whose launch checks are cached

template <typename T, int EPT>
__global__ void __launch_bounds__(SX_SOFTMAX_CLUSTER_THREADS) sx_softmax_cluster_kernel(
    const T* __restrict__ x, T* __restrict__ y, int cols, int slice) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float red[SX_SOFTMAX_CLUSTER_THREADS / 32];
  __shared__ float2 part;  // this block's (m_b, s_b), read by the whole cluster
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / nblk;
  const int lo = rank * slice;
  const int hi = min(cols, lo + slice);
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  float v[EPT];
  float m = sx_lowest<float>();
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int c = lo + threadIdx.x + j * SX_SOFTMAX_CLUSTER_THREADS;
    v[j] = c < hi ? sx_load(xr + c) : sx_lowest<float>();
    m = sx_max(m, v[j]);
  }
  m = sx_group_reduce(m, SX_SOFTMAX_CLUSTER_THREADS, red, SxMax());
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    v[j] = expf(v[j] - m);  // kept for the write: e = exp(x - m_b)
    if (lo + threadIdx.x + j * SX_SOFTMAX_CLUSTER_THREADS < hi) s += v[j];
  }
  s = sx_group_reduce(s, SX_SOFTMAX_CLUSTER_THREADS, red, SxSum());
  if (threadIdx.x == 0) part = make_float2(m, s);
  cluster.sync();  // every block's pair is written
  float2 pairs[SX_SOFTMAX_MAX_CLUSTER];  // one distributed-shared read a peer
  float mr = sx_lowest<float>();
#pragma unroll
  for (int r = 0; r < SX_SOFTMAX_MAX_CLUSTER; ++r) {
    if (r < nblk) {
      pairs[r] = *cluster.map_shared_rank(&part, r);
      mr = sx_max(mr, pairs[r].x);
    }
  }
  float sr = 0.0f;
#pragma unroll
  for (int r = 0; r < SX_SOFTMAX_MAX_CLUSTER; ++r) {
    // a wholly -inf slice has s_b = NaN and weighs exp(-inf) = 0: it adds 0
    if (r < nblk && pairs[r].x != sx_lowest<float>()) sr += pairs[r].y * expf(pairs[r].x - mr);
  }
  // exp(x - m) / s = e * scale.  A wholly -inf slice has e = NaN, and its
  // outputs are exp(-inf - m) / s = scale itself (0, or NaN in a row that
  // is -inf, NaN or +inf somewhere, as in the reference).
  const float scale = expf(m - mr) / sr;
  const bool empty = m == sx_lowest<float>();
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int c = lo + threadIdx.x + j * SX_SOFTMAX_CLUSTER_THREADS;
    if (c < hi) sx_store(yr + c, empty ? scale : v[j] * scale);
  }
  cluster.sync();  // no block leaves while a peer may still read its pair
}

// One launch of `blocks_per_row` blocks a row as one cluster.  Whether such
// a cluster fits on the card is asked once per device and instantiation
// (cudaOccupancyMaxActiveClusters); where none fits the launch is refused
// with cudaErrorInvalidClusterSize, never made another way.
template <typename T, int EPT>
static int sx_softmax_cluster_launch_ept(const T* x, T* y, int rows, int cols,
                                         int blocks_per_row, int slice, cudaStream_t stream) {
  static std::atomic<int> fits[kSxDevices];  // 0: not asked yet, 1: fits, -1: does not
  void (*kernel)(const T*, T*, int, int) = sx_softmax_cluster_kernel<T, EPT>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * blocks_per_row, 1, 1);
  cfg.blockDim = dim3(SX_SOFTMAX_CLUSTER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks_per_row;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  cudaGetDevice(&dev);
  int fit = dev < kSxDevices ? fits[dev].load(std::memory_order_relaxed) : 0;
  if (fit == 0) {
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    fit = clusters > 0 ? 1 : -1;
    if (dev < kSxDevices) fits[dev].store(fit, std::memory_order_relaxed);
  }
  if (fit < 0) return static_cast<int>(cudaErrorInvalidClusterSize);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, y, cols, slice);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int sx_softmax_cluster_launch(const T* x, T* y, int rows, int cols, int blocks_per_row,
                                     int slice, void* stream) {
  if (blocks_per_row < 1 || blocks_per_row > SX_SOFTMAX_MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidClusterSize);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ept = (slice + SX_SOFTMAX_CLUSTER_THREADS - 1) / SX_SOFTMAX_CLUSTER_THREADS;
  if (ept <= 1) return sx_softmax_cluster_launch_ept<T, 1>(x, y, rows, cols, blocks_per_row, slice, s);
  if (ept <= 2) return sx_softmax_cluster_launch_ept<T, 2>(x, y, rows, cols, blocks_per_row, slice, s);
  if (ept <= 4) return sx_softmax_cluster_launch_ept<T, 4>(x, y, rows, cols, blocks_per_row, slice, s);
  if (ept <= 8) return sx_softmax_cluster_launch_ept<T, 8>(x, y, rows, cols, blocks_per_row, slice, s);
  if (ept <= 16) return sx_softmax_cluster_launch_ept<T, 16>(x, y, rows, cols, blocks_per_row, slice, s);
  if (ept <= 32) return sx_softmax_cluster_launch_ept<T, 32>(x, y, rows, cols, blocks_per_row, slice, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sx_softmax_cluster_f32(const float* x, float* y, int rows, int cols,
                                      int blocks_per_row, int slice, void* stream) {
  return sx_softmax_cluster_launch(x, y, rows, cols, blocks_per_row, slice, stream);
}

extern "C" int sx_softmax_cluster_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int rows,
                                       int cols, int blocks_per_row, int slice, void* stream) {
  return sx_softmax_cluster_launch(x, y, rows, cols, blocks_per_row, slice, stream);
}

extern "C" int sx_softmax_cluster_f16(const __half* x, __half* y, int rows,
                                       int cols, int blocks_per_row, int slice, void* stream) {
  return sx_softmax_cluster_launch(x, y, rows, cols, blocks_per_row, slice, stream);
}

// ---------------------------------------------------------------- rmsnorm
// The scalar kernel: any d, any alignment; x read twice.
template <typename T>
__global__ void __launch_bounds__(1024) sx_rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ y, int cols,
    int rows_per_block, float eps) {
  __shared__ float red[32];
  const int group = blockDim.x / rows_per_block;
  const int t = threadIdx.x % group;
  const long long row = (long long)blockIdx.x * rows_per_block + threadIdx.x / group;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  float ss = 0.0f;
  for (int c = t; c < cols; c += group) {
    const float v = sx_load(xr + c);
    ss += v * v;
  }
  ss = sx_group_reduce(ss, group, red, SxSum());
  const float inv = 1.0f / sqrtf(ss / (float)cols + eps);  // IEEE, as jax.lax.rsqrt
  for (int c = t; c < cols; c += group) sx_store(yr + c, sx_load(xr + c) * inv * sx_load(gamma + c));
}

template <typename T>
static int sx_rmsnorm_launch(const T* x, const T* gamma, T* y, int rows, int cols,
                             int rows_per_block, int threads, float eps, void* stream) {
  sx_rmsnorm_kernel<T><<<rows / rows_per_block, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, gamma, y, cols, rows_per_block, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sx_rmsnorm_f32(const float* x, const float* gamma, float* y, int rows, int cols,
                              int rows_per_block, int threads, float eps, void* stream) {
  return sx_rmsnorm_launch(x, gamma, y, rows, cols, rows_per_block, threads, eps, stream);
}

extern "C" int sx_rmsnorm_bf16(const __nv_bfloat16* x, const __nv_bfloat16* gamma,
                               __nv_bfloat16* y, int rows, int cols, int rows_per_block,
                               int threads, float eps, void* stream) {
  return sx_rmsnorm_launch(x, gamma, y, rows, cols, rows_per_block, threads, eps, stream);
}

extern "C" int sx_rmsnorm_f16(const __half* x, const __half* gamma,
                               __half* y, int rows, int cols, int rows_per_block,
                               int threads, float eps, void* stream) {
  return sx_rmsnorm_launch(x, gamma, y, rows, cols, rows_per_block, threads, eps, stream);
}

// The 16-byte kernel.  One uint4 holds SxVec16<T>::N elements, in order.
constexpr int SX_RMS_THREADS = 256;  // threads of one block; a lane holds VPL <= 8 vectors

// A group of `warps_per_row` warps owns a row; lane t of the group holds
// the row's vectors t, t + group, ... (VPL of them), so a warp's loads are
// neighbouring 16-byte words.  The block's row groups stride over the rows
// together (the loop bound is the same for the whole block, so the group
// merge may synchronise the block).
template <typename T, int VPL>
__global__ void __launch_bounds__(SX_RMS_THREADS) sx_rmsnorm_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ y, int rows, int cols,
    int warps_per_row, float eps) {
  using V = SxVec16<T>;
  __shared__ float red[SX_RMS_THREADS / 32];
  const int group = 32 * warps_per_row;
  const int t = threadIdx.x % group;
  const int rows_per_block = blockDim.x / group;
  const int nv = cols / V::N;
  uint4 gv[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = t + group * j;
    if (c < nv) gv[j] = reinterpret_cast<const uint4*>(gamma)[c];
  }
  for (long long base = (long long)blockIdx.x * rows_per_block; base < rows;
       base += (long long)gridDim.x * rows_per_block) {
    const long long row = base + threadIdx.x / group;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * cols);
    uint4 xv[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = t + group * j;
      if (live && c < nv) xv[j] = xr[c];
    }
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (live && t + group * j < nv) {
        float f[V::N];
        V::unpack(xv[j], f);
#pragma unroll
        for (int i = 0; i < V::N; ++i) ss += f[i] * f[i];
      }
    }
    ss = sx_group_reduce(ss, group, red, SxSum());
    const float inv = 1.0f / sqrtf(ss / (float)cols + eps);  // IEEE, as jax.lax.rsqrt
    uint4* yr = reinterpret_cast<uint4*>(y + row * cols);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = t + group * j;
      if (live && c < nv) {
        float f[V::N], g[V::N];
        V::unpack(xv[j], f);
        V::unpack(gv[j], g);
#pragma unroll
        for (int i = 0; i < V::N; ++i) f[i] = f[i] * inv * g[i];
        yr[c] = V::pack(f);
      }
    }
  }
}

// As many blocks as the card holds at once, at most one per row group.
// The runtime is asked once per device and block size (the occupancy query
// costs the host about as much as the launch); the grid changes only the
// speed, since the row groups stride over every row.
template <typename T, int VPL>
static int sx_rmsnorm_vec_launch_vpl(const T* x, const T* gamma, T* y, int rows, int cols,
                                     int warps_per_row, int rows_per_block, float eps,
                                     cudaStream_t stream) {
  static std::atomic<int> resident[kSxDevices][SX_RMS_THREADS / 32];  // 0: not asked yet
  const int threads = 32 * warps_per_row * rows_per_block;
  int dev = 0;
  cudaGetDevice(&dev);
  int held = dev < kSxDevices ? resident[dev][threads / 32 - 1].load(std::memory_order_relaxed) : 0;
  if (held == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sx_rmsnorm_vec_kernel<T, VPL>, threads, 0);
    held = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev < kSxDevices) resident[dev][threads / 32 - 1].store(held, std::memory_order_relaxed);
  }
  const int want = (rows + rows_per_block - 1) / rows_per_block;
  const int blocks = want < held ? want : held;
  sx_rmsnorm_vec_kernel<T, VPL><<<blocks, threads, 0, stream>>>(
      x, gamma, y, rows, cols, warps_per_row, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int sx_rmsnorm_vec_launch(const T* x, const T* gamma, T* y, int rows, int cols,
                                 int warps_per_row, int rows_per_block, float eps, void* stream) {
  const int nv = cols / SxVec16<T>::N;
  const int vpl = (nv + 32 * warps_per_row - 1) / (32 * warps_per_row);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vpl) {
    case 1: return sx_rmsnorm_vec_launch_vpl<T, 1>(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, s);
    case 2: return sx_rmsnorm_vec_launch_vpl<T, 2>(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, s);
    case 3: return sx_rmsnorm_vec_launch_vpl<T, 3>(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, s);
    case 4: return sx_rmsnorm_vec_launch_vpl<T, 4>(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, s);
    case 5: return sx_rmsnorm_vec_launch_vpl<T, 5>(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, s);
    case 6: return sx_rmsnorm_vec_launch_vpl<T, 6>(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, s);
    case 7: return sx_rmsnorm_vec_launch_vpl<T, 7>(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, s);
    case 8: return sx_rmsnorm_vec_launch_vpl<T, 8>(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sx_rmsnorm_vec_f32(const float* x, const float* gamma, float* y, int rows,
                                  int cols, int warps_per_row, int rows_per_block, float eps,
                                  void* stream) {
  return sx_rmsnorm_vec_launch(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, stream);
}

extern "C" int sx_rmsnorm_vec_bf16(const __nv_bfloat16* x, const __nv_bfloat16* gamma,
                                   __nv_bfloat16* y, int rows, int cols, int warps_per_row,
                                   int rows_per_block, float eps, void* stream) {
  return sx_rmsnorm_vec_launch(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, stream);
}

extern "C" int sx_rmsnorm_vec_f16(const __half* x, const __half* gamma,
                                   __half* y, int rows, int cols, int warps_per_row,
                                   int rows_per_block, float eps, void* stream) {
  return sx_rmsnorm_vec_launch(x, gamma, y, rows, cols, warps_per_row, rows_per_block, eps, stream);
}

// ---------------------------------------------------------------- moe gate
constexpr int SX_GATE_WARPS = 8;  // tokens of one block, a warp each

// p as an unsigned key in the argmax's order: NaN above every number, then
// the floats in their order, -0 the key of +0.  No key is 0, so 0 marks a
// slot that holds no expert.
SX_D unsigned sx_gate_key(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The number a key stands for; the NaN key gives a NaN.
SX_D float sx_gate_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

template <typename T, int SLOTS>
__global__ void __launch_bounds__(32 * SX_GATE_WARPS) sx_moe_gate_kernel(
    const T* __restrict__ logits, float* __restrict__ w, int* __restrict__ idx, int tokens,
    int E, int top_k, int tokens_per_block) {
  const int lane = threadIdx.x & 31;
  const long long tok = (long long)blockIdx.x * tokens_per_block + threadIdx.x / 32;
  if (tok >= tokens) return;  // the tail of T: whole warps leave
  const T* xt = logits + tok * E;
  float p[SLOTS];
  float m = sx_lowest<float>();
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? sx_load(xt + e) : 0.0f;
    if (e < E) m = sx_max(m, p[j]);
  }
  m = sx_warp_reduce(m, SxMax());
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    if (lane + 32 * j < E) {
      p[j] = expf(p[j] - m);
      s += p[j];
    }
  }
  s = sx_warp_reduce(s, SxSum());
  unsigned key[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    p[j] = p[j] / s;
    key[j] = lane + 32 * j < E ? sx_gate_key(p[j]) : 0u;
  }

  float total = 0.0f, my_w = 0.0f;
  int my_i = 0;
  for (int r = 0; r < top_k; ++r) {
    unsigned best = key[0];
#pragma unroll
    for (int j = 1; j < SLOTS; ++j) best = key[j] > best ? key[j] : best;
    best = sx_warp_max_u32(best);
    int bi = 0;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const unsigned holders = sx_ballot(key[j] == best);  // the same in every lane
      if (holders) {
        bi = 32 * j + sx_ffs(holders) - 1;
        break;
      }
    }
    const float bv = sx_gate_value(best);
    total += bv;
    if (lane == r) {
      my_w = bv;
      my_i = bi;
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (lane + 32 * j == bi) {
        p[j] -= 2.0f;
        key[j] = sx_gate_key(p[j]);
      }
    }
  }
  if (lane < top_k) {
    w[tok * top_k + lane] = my_w / total;
    idx[tok * top_k + lane] = my_i;
  }
}

template <typename T>
static int sx_moe_gate_launch(const T* logits, float* w, int* idx, int tokens, int E, int top_k,
                              int tokens_per_block, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 32 * tokens_per_block;
  const int slots = (E + 31) / 32;
  if (slots <= 1) {
    sx_moe_gate_kernel<T, 1><<<blocks, threads, 0, s>>>(logits, w, idx, tokens, E, top_k, tokens_per_block);
  } else if (slots <= 2) {
    sx_moe_gate_kernel<T, 2><<<blocks, threads, 0, s>>>(logits, w, idx, tokens, E, top_k, tokens_per_block);
  } else if (slots <= 4) {
    sx_moe_gate_kernel<T, 4><<<blocks, threads, 0, s>>>(logits, w, idx, tokens, E, top_k, tokens_per_block);
  } else {
    sx_moe_gate_kernel<T, 8><<<blocks, threads, 0, s>>>(logits, w, idx, tokens, E, top_k, tokens_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sx_moe_gate_f32(const float* logits, float* w, int* idx, int tokens, int E,
                               int top_k, int tokens_per_block, int blocks, void* stream) {
  return sx_moe_gate_launch(logits, w, idx, tokens, E, top_k, tokens_per_block, blocks, stream);
}

extern "C" int sx_moe_gate_bf16(const __nv_bfloat16* logits, float* w, int* idx, int tokens,
                                int E, int top_k, int tokens_per_block, int blocks,
                                void* stream) {
  return sx_moe_gate_launch(logits, w, idx, tokens, E, top_k, tokens_per_block, blocks, stream);
}

extern "C" int sx_moe_gate_f16(const __half* logits, float* w, int* idx, int tokens,
                                int E, int top_k, int tokens_per_block, int blocks,
                                void* stream) {
  return sx_moe_gate_launch(logits, w, idx, tokens, E, top_k, tokens_per_block, blocks, stream);
}
