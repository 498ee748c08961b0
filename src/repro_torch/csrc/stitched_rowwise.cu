// The row-wise hand-written kernels of repro_torch.kernels: softmax,
// RMSNorm and the MoE router gate, each one pass over its rows with the
// reduction kept on chip.
//
// stitched_softmax replaces repro/kernels/stitched_softmax.py
//   stitched_softmax (_softmax_kernel).
// stitched_rmsnorm replaces repro/kernels/stitched_rmsnorm.py
//   stitched_rmsnorm (_rmsnorm_kernel).
//   Both are bound by bytes: a handful of f32 operations per element.  A
//   group of 32..1024 threads owns a row and walks it with a block stride,
//   so a warp's loads are neighbouring addresses; the row's max and sum
//   are f32 warp-shuffle reductions, merged across the group's warps in
//   shared memory.  The row is not staged: softmax reads x again in its
//   sum and write passes (a 49,155-wide f32 vocab row is 196 KB, most of a
//   block's shared memory, while the re-reads hit L2).  A block holds
//   `rows_per_block` rows, so narrow rows still fill whole warps.
//
// stitched_moe_gate replaces repro/kernels/stitched_moe_gate.py
//   stitched_moe_gate (_gate_kernel).
//   Bound by bytes (E logits in, 2k values out per token).  A warp owns a
//   token and its lanes hold the E <= 256 logits, eight a lane at most.
//   Softmax by shuffles, then top_k rounds of a warp argmax in which the
//   larger probability wins and the lower expert index breaks ties (NaN
//   above all, as jnp.argmax), the pick lowered by 2.0 as the Pallas
//   kernel does, then the k weights renormalised by their sum, added in
//   pick order.
//
// Each launcher is extern "C", one per element type, and returns
// cudaGetLastError() so a refused launch reaches the Python wrapper.

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

// ---------------------------------------------------------------- rmsnorm
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

// ---------------------------------------------------------------- moe gate
constexpr int SX_GATE_PER_LANE = 8;  // logits a lane holds: E <= 256

// Does (a, ia) rank above (b, ib)?  An index below 0 is no candidate.
SX_D bool sx_gate_above(float a, int ia, float b, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

template <typename T>
__global__ void __launch_bounds__(1024) sx_moe_gate_kernel(
    const T* __restrict__ logits, float* __restrict__ w, int* __restrict__ idx, int E,
    int top_k, int tokens_per_block) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  for (int i = threadIdx.x / 32; i < tokens_per_block; i += warps) {
    const long long tok = (long long)blockIdx.x * tokens_per_block + i;
    const T* xt = logits + tok * E;
    float p[SX_GATE_PER_LANE];
    float m = sx_lowest<float>();
#pragma unroll
    for (int j = 0; j < SX_GATE_PER_LANE; ++j) {
      const int e = lane + 32 * j;
      p[j] = e < E ? sx_load(xt + e) : 0.0f;
      if (e < E) m = sx_max(m, p[j]);
    }
    m = sx_warp_reduce(m, SxMax());
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < SX_GATE_PER_LANE; ++j) {
      if (lane + 32 * j < E) {
        p[j] = expf(p[j] - m);
        s += p[j];
      }
    }
    s = sx_warp_reduce(s, SxSum());
#pragma unroll
    for (int j = 0; j < SX_GATE_PER_LANE; ++j) p[j] = p[j] / s;

    float total = 0.0f, my_w = 0.0f;
    int my_i = 0;
    for (int r = 0; r < top_k; ++r) {
      float bv = 0.0f;
      int bi = -1;
#pragma unroll
      for (int j = 0; j < SX_GATE_PER_LANE; ++j) {
        const int e = lane + 32 * j;
        if (e < E && sx_gate_above(p[j], e, bv, bi)) {
          bv = p[j];
          bi = e;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(SX_FULL_MASK, bv, o);
        const int oi = __shfl_xor_sync(SX_FULL_MASK, bi, o);
        if (sx_gate_above(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      total += bv;
      if (lane == r) {
        my_w = bv;
        my_i = bi;
      }
#pragma unroll
      for (int j = 0; j < SX_GATE_PER_LANE; ++j) {
        if (lane + 32 * j == bi) p[j] -= 2.0f;
      }
    }
    if (lane < top_k) {
      w[tok * top_k + lane] = my_w / total;
      idx[tok * top_k + lane] = my_i;
    }
  }
}

template <typename T>
static int sx_moe_gate_launch(const T* logits, float* w, int* idx, int tokens, int E, int top_k,
                              int tokens_per_block, int threads, void* stream) {
  sx_moe_gate_kernel<T><<<tokens / tokens_per_block, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(logits, w, idx, E, top_k,
                                                               tokens_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sx_moe_gate_f32(const float* logits, float* w, int* idx, int tokens, int E,
                               int top_k, int tokens_per_block, int threads, void* stream) {
  return sx_moe_gate_launch(logits, w, idx, tokens, E, top_k, tokens_per_block, threads, stream);
}

extern "C" int sx_moe_gate_bf16(const __nv_bfloat16* logits, float* w, int* idx, int tokens,
                                int E, int top_k, int tokens_per_block, int threads,
                                void* stream) {
  return sx_moe_gate_launch(logits, w, idx, tokens, E, top_k, tokens_per_block, threads, stream);
}
