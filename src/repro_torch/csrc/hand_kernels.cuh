// Helpers shared by the hand-written kernels of repro_torch.kernels
// (stitched_rowwise.cu, stitched_attention.cu), the warp votes of the MoE
// gate (redux.sync, ballot, ffs) and the warp-level PTX instructions of the
// attention kernels (cp.async, ldmatrix, mma.sync).
//
// Every kernel reads float, bf16 or f16, computes in f32 and casts once
// when it stores, as the Pallas kernels it replaces do.  bf16 and f16
// stores round to nearest even (__float2bfloat16, __float2half_rn), as
// torch's casts do.  Max reductions
// propagate NaN like jnp.max (sx_max of stitch_runtime.cuh; fmaxf would
// drop it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <string.h>

#include <type_traits>

#include "stitch_runtime.cuh"

#define SX_FULL_MASK 0xffffffffu

// The attention kernels' mask value, as the Pallas kernels' NEG_INF.
constexpr float SX_NEG_INF = -1e30f;

SX_D float sx_load(const float* p) { return *p; }
SX_D float sx_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
SX_D void sx_store(float* p, float v) { *p = v; }
SX_D void sx_store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
SX_D float sx_load(const __half* p) { return __half2float(*p); }
SX_D void sx_store(__half* p, float v) { *p = __float2half_rn(v); }

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

// ---------------------------------------------------------------------------
// Warp votes of the MoE gate: one instruction each on sm_80+ (redux.sync,
// vote.ballot, the bit scan of __ffs).  Where __CUDA_ARCH__ is not defined
// each does the same work with shuffles, as the PTX helpers below do.  All
// 32 lanes must take part.

// The largest `v` over the warp's 32 lanes, in every lane.
SX_D unsigned sx_warp_max_u32(unsigned v) {
#ifdef __CUDA_ARCH__
  return __reduce_max_sync(SX_FULL_MASK, v);
#else
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned w = __shfl_xor_sync(SX_FULL_MASK, v, o);
    v = w > v ? w : v;
  }
  return v;
#endif
}

// Bit i set where lane i's `pred` holds, in every lane.
SX_D unsigned sx_ballot(bool pred) {
#ifdef __CUDA_ARCH__
  return __ballot_sync(SX_FULL_MASK, pred);
#else
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (unsigned)__shfl_sync(SX_FULL_MASK, (unsigned)pred, i) << i;
  return b;
#endif
}

// 1 + the position of the lowest set bit of `b`, 0 for b == 0.
SX_D int sx_ffs(unsigned b) {
#ifdef __CUDA_ARCH__
  return __ffs(b);
#else
  for (int i = 0; i < 32; ++i)
    if ((b >> i) & 1u) return i + 1;
  return 0;
#endif
}

// ---------------------------------------------------------------------------
// One PTX instruction each: the asynchronous copy, ldmatrix and the bf16 or
// f16 tensor-core product of the attention kernels.  Where __CUDA_ARCH__ is not
// defined (nvcc's host pass, or a rehearsal of a source with a host
// compiler that runs one thread per CUDA thread) each does the same work in
// scalar code, lane by lane, following the instruction's fragment layout,
// with the warp's exchanges done by shuffles.  Fragment layouts: PTX ISA,
// "Matrix fragments for mma.m16n8k16" and "ldmatrix".  g = lane / 4 and
// t = lane % 4 below.

// 16 bytes from global to shared memory without going through registers;
// with !valid the 16 bytes are zero-filled and nothing is read.  Both
// addresses are 16-byte aligned.
SX_D void sx_cp_async16(void* dst, const void* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
#else
  if (valid) {
    memcpy(dst, src, 16);
  } else {
    memset(dst, 0, 16);
  }
#endif
}

// Close the group of copies this thread issued since the last commit.
SX_D void sx_cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
SX_D void sx_cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// Two floats as one register of two bf16, rounded to nearest even; lo in
// the low half, as the fragments order a row's neighbouring columns.
SX_D unsigned sx_pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

SX_D float sx_bf16_lo(unsigned r) { return __uint_as_float(r << 16); }
SX_D float sx_bf16_hi(unsigned r) { return __uint_as_float(r & 0xffff0000u); }

// The same for f16: two floats as one register of two f16, rounded to
// nearest even, and each half of such a register as a float.
SX_D unsigned sx_pack_f16x2(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
SX_D float sx_f16_lo(unsigned r) { return __half2float(__ushort_as_half((unsigned short)(r & 0xffffu))); }
SX_D float sx_f16_hi(unsigned r) { return __half2float(__ushort_as_half((unsigned short)(r >> 16))); }

// The 2-byte element types by their type: pack two floats, unpack a half.
template <typename T>
struct SxPair;
template <>
struct SxPair<__nv_bfloat16> {
  SX_D static unsigned pack(float lo, float hi) { return sx_pack_bf16x2(lo, hi); }
  SX_D static float lo(unsigned r) { return sx_bf16_lo(r); }
  SX_D static float hi(unsigned r) { return sx_bf16_hi(r); }
};
template <>
struct SxPair<__half> {
  SX_D static unsigned pack(float lo, float hi) { return sx_pack_f16x2(lo, hi); }
  SX_D static float lo(unsigned r) { return sx_f16_lo(r); }
  SX_D static float hi(unsigned r) { return sx_f16_hi(r); }
};

// 16 bytes as SxVec16<T>::N elements, in order, unpacked to floats or
// packed from them (rounded to nearest even).
template <typename T>
struct SxVec16;

template <>
struct SxVec16<float> {
  static constexpr int N = 4;
  SX_D static void unpack(const uint4& v, float (&f)[N]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  SX_D static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// bf16 and f16: eight 2-byte elements, two a word, the lower one first.
template <typename T>
struct SxVec16Pairs {
  static constexpr int N = 8;
  SX_D static void unpack(const uint4& v, float (&f)[N]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = SxPair<T>::lo(w[i]);
      f[2 * i + 1] = SxPair<T>::hi(w[i]);
    }
  }
  SX_D static uint4 pack(const float (&f)[N]) {
    return make_uint4(SxPair<T>::pack(f[0], f[1]), SxPair<T>::pack(f[2], f[3]),
                      SxPair<T>::pack(f[4], f[5]), SxPair<T>::pack(f[6], f[7]));
  }
};
template <>
struct SxVec16<__nv_bfloat16> : SxVec16Pairs<__nv_bfloat16> {};
template <>
struct SxVec16<__half> : SxVec16Pairs<__half> {};

#ifndef __CUDA_ARCH__
// The row address that lane `src` gave an emulated ldmatrix.
SX_D const unsigned short* sx_shfl_row(const void* row, int src) {
  return reinterpret_cast<const unsigned short*>(
      __shfl_sync(SX_FULL_MASK, reinterpret_cast<unsigned long long>(row), src));
}
#endif

// ldmatrix .x4: four 8x8 matrices of 2-byte elements (bf16 or f16) from
// shared memory.  Lane i gives the address of row i % 8 of matrix i / 8 (16
// contiguous bytes); register j receives row g, columns 2t and 2t + 1 of
// matrix j.
SX_D void sx_ldmatrix_x4(unsigned (&r)[4], const void* row) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
#else
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < 4; ++j) {
    const unsigned short* p = sx_shfl_row(row, 8 * j + lane / 4);
    r[j] = (unsigned)p[2 * (lane % 4)] | ((unsigned)p[2 * (lane % 4) + 1] << 16);
  }
#endif
}

// ldmatrix .x4 .trans: the same addresses; register j receives rows 2t and
// 2t + 1 of column g of matrix j, i.e. the matrix transposed.
SX_D void sx_ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
#else
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < 4; ++j) {
    const unsigned short* p0 = sx_shfl_row(row, 8 * j + 2 * (lane % 4));
    const unsigned short* p1 = sx_shfl_row(row, 8 * j + 2 * (lane % 4) + 1);
    r[j] = (unsigned)p0[lane / 4] | ((unsigned)p1[lane / 4] << 16);
  }
#endif
}

// d += a * b on the tensor cores: mma.sync m16n8k16, bf16 or f16 in (T), f32
// sums.  a is 16x16 row-major: a[0] row g, columns 2t..2t+1; a[1] row g + 8;
// a[2] row g, columns 2t + 8..; a[3] row g + 8, columns 2t + 8...  b is
// 16x8: b[0] rows 2t..2t+1 of column g, b[1] rows 2t + 8...  d is 16x8:
// d[0..1] row g, columns 2t..2t+1; d[2..3] row g + 8.
template <typename T>
SX_D void sx_mma_16816(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
#else
  using P = SxPair<T>;
  const int lane = threadIdx.x & 31, g = lane / 4, t = lane % 4;
  for (int tp = 0; tp < 4; ++tp) {  // columns 2tp.. and 2tp + 8.. of a, rows of b
    unsigned A[4], B[2][2];
    for (int i = 0; i < 4; ++i) A[i] = __shfl_sync(SX_FULL_MASK, a[i], 4 * g + tp);
    for (int c = 0; c < 2; ++c)
      for (int i = 0; i < 2; ++i) B[c][i] = __shfl_sync(SX_FULL_MASK, b[i], 4 * (2 * t + c) + tp);
    for (int c = 0; c < 2; ++c) {
      for (int h = 0; h < 2; ++h) {  // row g, row g + 8
        d[2 * h + c] += P::lo(A[h]) * P::lo(B[c][0]) + P::hi(A[h]) * P::hi(B[c][0]) +
                        P::lo(A[2 + h]) * P::lo(B[c][1]) + P::hi(A[2 + h]) * P::hi(B[c][1]);
      }
    }
  }
#endif
}
