// Helpers shared by the hand-written kernels of repro_torch.kernels
// (stitched_rowwise.cu, stitched_attention.cu), the warp votes of the MoE
// gate (redux.sync, ballot, ffs) and the asynchronous copy of the attention
// kernels (cp.async); their ldmatrix and mma.sync are stitch_runtime.cuh's.
//
// The Hopper section at the end holds the mbarrier, TMA, wgmma and
// setmaxnreg instructions of the wgmma flash kernel; they exist only for
// sm_90a, and where __CUDA_ARCH__ is not defined they do nothing.
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
// The asynchronous copy of the attention kernels, one PTX instruction each
// (ldmatrix and the tensor-core product, which the generated kernels use
// too, are in stitch_runtime.cuh).  Where __CUDA_ARCH__ is not defined
// each does the same work in scalar code.

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

// ---------------------------------------------------------------------------
// Hopper (sm_90a): mbarriers, TMA tile loads, wgmma and setmaxnreg, one PTX
// instruction each (PTX ISA: "mbarrier", "cp.async.bulk.tensor",
// "Asynchronous Warpgroup Level Matrix Multiply-Accumulate Operation").
// Shared-memory operands are 32-bit shared-window addresses
// (sx_smem_addr).  They have no host branch: a rehearsal on the host
// cannot run the wgmma kernel.

SX_D unsigned sx_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialise an mbarrier that completes a phase after `count` arrivals
// (and, where a TMA load expects bytes, after they have landed).
SX_D void sx_mbar_init(unsigned bar, unsigned count) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
#endif
}

// Make the initialised barriers visible to the async proxy (TMA).
SX_D void sx_mbar_fence_init() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

SX_D void sx_mbar_arrive(unsigned bar) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
#endif
}

// Arrive and add `bytes` to the transactions the current phase waits for.
SX_D void sx_mbar_expect_tx(unsigned bar, unsigned bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
#endif
}

// Wait until the phase of parity `parity` has completed.  A wait that
// lasts past SX_MBAR_TIMEOUT cycles (about 2.3 s at 1.755 GHz) traps: a
// fault in the pipeline ends the launch with an error instead of hanging
// the card.
constexpr long long SX_MBAR_TIMEOUT = 4000000000LL;
SX_D void sx_mbar_wait(unsigned bar, unsigned parity) {
#ifdef __CUDA_ARCH__
  unsigned done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > SX_MBAR_TIMEOUT) {
      __trap();
    }
  }
#endif
}

// A box of a 3-D tensor map (coordinates innermost first) into shared
// memory at `dst`, completing `bytes` of `bar`'s transactions.  Elements
// past the tensor's extent land as zeros.
SX_D void sx_tma_load_3d(unsigned dst, const void* map, unsigned bar, int c0, int c1, int c2) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
#endif
}

// The tensor map's descriptor line into the cache before its first use.
SX_D void sx_tma_prefetch(const void* map) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(map))
               : "memory");
#endif
}

// max(a, b) that propagates NaN, as sx_max does, in one instruction.
SX_D float sx_fmax_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return sx_max(a, b);
#endif
}

// 2^x on the special-function unit (ex2.approx, results below 2^-126
// flushed to 0): what exp2f compiles to, without its denormal fix-ups.
SX_D float sx_exp2(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return exp2f(x);
#endif
}

// Named barrier `id` (1..15; 0 is __syncthreads') of `threads` threads:
// sync waits for all of them, arrive counts this warp in and goes on.
SX_D void sx_bar_sync(int id, int threads) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
#endif
}
SX_D void sx_bar_arrive(int id, int threads) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
#endif
}

// Registers a thread of this warpgroup may hold from here on.
template <int N>
SX_D void sx_setmaxnreg_inc() {
#ifdef __CUDA_ARCH__
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}
template <int N>
SX_D void sx_setmaxnreg_dec() {
#ifdef __CUDA_ARCH__
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

// A shared-memory matrix descriptor of wgmma in the 128-byte swizzle: the
// start address, the leading and stride byte offsets (16-byte units) and
// layout type 1 (SWIZZLE_128B) in bits 62-63.  The swizzle atom is 8 rows
// of 128 bytes; every atom must start on a 1024-byte boundary, so the base
// offset (bits 49-51) stays 0.
SX_D uint64_t sx_wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | 1ull << 62;
}

// Order this warpgroup's register and shared-memory writes before the
// wgmma that follows reads them: needed before the first wgmma and after
// any other instruction wrote an accumulator or A register.
SX_D void sx_wgmma_fence() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

SX_D void sx_wgmma_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

template <int N>
SX_D void sx_wgmma_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#endif
}

// Pin registers in place across the asynchronous products: the compiler
// sees each wgmma's accumulators written when it is issued, so without this
// it may move a read of them above wgmma.wait_group, or a write of them
// (the O rescale) below the wgmma that reads them.
template <int N>
SX_D void sx_pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
SX_D void sx_pin(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x N f32 accumulators of the warpgroup, N / 2 a thread) = or += a b
// on the tensor cores, wgmma m64nNk16, bf16 or f16 in.  ss (N = 128): a and
// b are shared-memory descriptors, both K-major; scale_d 0 gives d = a b.  rs: a
// is this thread's A fragment in registers (the layout of mma.sync
// m16n8k16's A for the warp's 16 rows), b a descriptor of an MN-major
// (transposed) matrix; d += a b.  Accumulator layout: warp w of the group
// holds rows 16 w + g and 16 w + g + 8; element 4 j + 2 r + c is column
// 8 j + 2 t + c of row 16 w + g + 8 r.
template <typename T, int N>
struct SxWgmma;
template <>
struct SxWgmma<__nv_bfloat16, 64> {
  SX_D static void rs(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#endif
  }
};
template <>
struct SxWgmma<__nv_bfloat16, 128> {
  SX_D static void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
#endif
  }
  SX_D static void rs(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#endif
  }
};
template <>
struct SxWgmma<__half, 64> {
  SX_D static void rs(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#endif
  }
};
template <>
struct SxWgmma<__half, 128> {
  SX_D static void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
#endif
  }
  SX_D static void rs(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#endif
  }
};
