// Helpers shared by the hand-written kernels of repro_torch.kernels
// (stitched_rowwise.cu, stitched_attention.cu).
//
// Every kernel reads float or bf16, computes in f32 and casts once when it
// stores, as the Pallas kernels it replaces do.  bf16 stores round to
// nearest even (__float2bfloat16), as torch's casts do.  Max reductions
// propagate NaN like jnp.max (sx_max of stitch_runtime.cuh; fmaxf would
// drop it).
#pragma once

#include <cuda_bf16.h>

#include "stitch_runtime.cuh"

#define SX_FULL_MASK 0xffffffffu

// The attention kernels' mask value, as the Pallas kernels' NEG_INF.
constexpr float SX_NEG_INF = -1e30f;

SX_D float sx_load(const float* p) { return *p; }
SX_D float sx_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
SX_D void sx_store(float* p, float v) { *p = v; }
SX_D void sx_store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct SxSum {
  SX_D float operator()(float a, float b) const { return a + b; }
};
struct SxMax {
  SX_D float operator()(float a, float b) const { return sx_max(a, b); }
};

// Butterfly reduction over the 32 lanes of a warp: every lane gets the
// same result.  All 32 lanes must take part.
template <typename Op>
SX_D float sx_warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(SX_FULL_MASK, v, o));
  return v;
}

// Reduction over each group of `group` consecutive threads of the block
// (`group` a multiple of 32 that divides blockDim.x): every thread of a
// group gets the same result.  Every thread of the block must call it,
// since it synchronises the block when a group spans several warps.
// `red` is shared memory of blockDim.x / 32 floats.
template <typename Op>
SX_D float sx_group_reduce(float v, int group, float* red, Op op) {
  v = sx_warp_reduce(v, op);
  if (group <= 32) return v;
  const int warps = group / 32;
  const int first = (threadIdx.x / group) * warps;
  __syncthreads();  // the previous reduction has read `red`
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[first];
  for (int w = 1; w < warps; ++w) v = op(v, red[first + w]);
  return v;
}
