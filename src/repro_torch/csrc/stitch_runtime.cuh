// Device helpers included by every source that core/codegen.py generates.
//
// One overload per element type the generated kernels compute in (float,
// double, int, long long, bool).  Values stored as bf16 or f16 are computed
// in float and those stored as int8, uint8 or int16 in int (cuda_bf16.h's and
// cuda_fp16.h's conversion intrinsics, each member rounded back to its
// dtype where it ends), so those types need only their identities and
// gather fills here.  The elementwise functions follow the reference's
// jnp/jax.nn semantics, not CUDA's fast intrinsics: the sources are built
// without --use_fast_math, rsqrt is 1/sqrt (two correctly rounded steps,
// not the approximate rsqrtf), gelu is the tanh form jax.nn.gelu uses by
// default, and max/min propagate NaN like jnp.maximum/jnp.minimum.
//
// The stitched kernels (emit_stitched_fusion) also use the warp reduction
// and the grid barrier below; their launchers cache each device's grid in
// a std::atomic.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#define SX_D __device__ __forceinline__

#define SX_FLOAT_UNARY(name, fexpr, dexpr)          \
  SX_D float sx_##name(float x) { return fexpr; }   \
  SX_D double sx_##name(double x) { return dexpr; }

SX_FLOAT_UNARY(exp, expf(x), exp(x))
SX_FLOAT_UNARY(log, logf(x), log(x))
SX_FLOAT_UNARY(tanh, tanhf(x), tanh(x))
SX_FLOAT_UNARY(sqrt, sqrtf(x), sqrt(x))
SX_FLOAT_UNARY(rsqrt, 1.0f / sqrtf(x), 1.0 / sqrt(x))
SX_FLOAT_UNARY(floor, floorf(x), floor(x))
SX_FLOAT_UNARY(cos, cosf(x), cos(x))
SX_FLOAT_UNARY(sin, sinf(x), sin(x))
SX_FLOAT_UNARY(reciprocal, 1.0f / x, 1.0 / x)
SX_FLOAT_UNARY(sigmoid, 1.0f / (1.0f + expf(-x)), 1.0 / (1.0 + exp(-x)))
SX_FLOAT_UNARY(silu, x * (1.0f / (1.0f + expf(-x))), x * (1.0 / (1.0 + exp(-x))))
// jax.nn.softplus(x) = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
SX_FLOAT_UNARY(softplus, fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))),
               fmax(x, 0.0) + log1p(exp(-fabs(x))))
// jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
SX_FLOAT_UNARY(gelu,
               x * (0.5f * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))))),
               x * (0.5 * (1.0 + tanh(0.7978845608028654 * (x + 0.044715 * (x * x * x))))))

SX_D float sx_abs(float x) { return fabsf(x); }
SX_D double sx_abs(double x) { return fabs(x); }
SX_D int sx_abs(int x) { return x < 0 ? -x : x; }
SX_D long long sx_abs(long long x) { return x < 0 ? -x : x; }

SX_D float sx_pow(float a, float b) { return powf(a, b); }
SX_D double sx_pow(double a, double b) { return pow(a, b); }

template <typename T> SX_D T sx_neg(T x) { return -x; }
template <typename T> SX_D T sx_square(T x) { return x * x; }
// jnp.sign: NaN stays NaN, zeros stay zero
template <typename T> SX_D T sx_sign(T x) {
  return x != x ? x : (T)((x > (T)0) - (x < (T)0));
}
// jnp.maximum / jnp.minimum propagate NaN (fmaxf/fminf would drop it)
template <typename T> SX_D T sx_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T> SX_D T sx_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

SX_D float sx_fma(float a, float b, float c) { return fmaf(a, b, c); }
SX_D double sx_fma(double a, double b, double c) { return fma(a, b, c); }
SX_D int sx_fma(int a, int b, int c) { return a * b + c; }
SX_D long long sx_fma(long long a, long long b, long long c) { return a * b + c; }

// Identities of max/min reductions, and jnp.take's "fill" value for rows
// whose index is out of range (NaN, the most negative int, true).
template <typename T> SX_D T sx_lowest();
template <typename T> SX_D T sx_highest();
template <typename T> SX_D T sx_fill();
template <> SX_D float sx_lowest<float>() { return __int_as_float(0xff800000); }
template <> SX_D float sx_highest<float>() { return __int_as_float(0x7f800000); }
template <> SX_D float sx_fill<float>() { return __int_as_float(0x7fc00000); }
template <> SX_D double sx_lowest<double>() { return __longlong_as_double(0xfff0000000000000ULL); }
template <> SX_D double sx_highest<double>() { return __longlong_as_double(0x7ff0000000000000ULL); }
template <> SX_D double sx_fill<double>() { return __longlong_as_double(0x7ff8000000000000ULL); }
template <> SX_D int sx_lowest<int>() { return -2147483647 - 1; }
template <> SX_D int sx_highest<int>() { return 2147483647; }
template <> SX_D int sx_fill<int>() { return -2147483647 - 1; }
template <> SX_D long long sx_lowest<long long>() { return -9223372036854775807LL - 1; }
template <> SX_D long long sx_highest<long long>() { return 9223372036854775807LL; }
template <> SX_D long long sx_fill<long long>() { return -9223372036854775807LL - 1; }
template <> SX_D bool sx_lowest<bool>() { return false; }
template <> SX_D bool sx_highest<bool>() { return true; }
template <> SX_D bool sx_fill<bool>() { return true; }
template <> SX_D signed char sx_lowest<signed char>() { return -128; }
template <> SX_D signed char sx_highest<signed char>() { return 127; }
template <> SX_D signed char sx_fill<signed char>() { return -128; }
template <> SX_D short sx_lowest<short>() { return -32768; }
template <> SX_D short sx_highest<short>() { return 32767; }
template <> SX_D short sx_fill<short>() { return -32768; }
// jnp fills unsigned rows with the largest value
template <> SX_D unsigned char sx_lowest<unsigned char>() { return 0; }
template <> SX_D unsigned char sx_highest<unsigned char>() { return 255; }
template <> SX_D unsigned char sx_fill<unsigned char>() { return 255; }
template <> SX_D __half sx_fill<__half>() { return __ushort_as_half(0x7e00); }
template <> SX_D __nv_bfloat16 sx_fill<__nv_bfloat16>() { return __ushort_as_bfloat16(0x7fc0); }

// jnp's conversion of a float to an integer type: truncation toward zero,
// NaN gives 0, values past the type's range saturate at its ends (a C cast
// of such a value is undefined).  For long long, hi rounds up to 2**63,
// so every x below it converts.
template <typename I> SX_D I sx_f2i(double x) {
  const double lo = static_cast<double>(sx_lowest<I>());
  const double hi = static_cast<double>(sx_highest<I>());
  if (x != x) return static_cast<I>(0);
  if (x <= lo) return sx_lowest<I>();
  if (x >= hi) return sx_highest<I>();
  return static_cast<I>(x);
}

// ---------------------------------------------------------------------------
// Cooperative reductions of the stitched kernels: the 32 lanes of a warp
// combine their partial results by butterfly shuffles, so every lane ends
// with the whole result.  All 32 lanes must take part.  bool travels as int.
template <typename T> SX_D T sx_shfl_xor(T v, int mask) { return __shfl_xor_sync(0xffffffffu, v, mask); }
template <> SX_D bool sx_shfl_xor<bool>(bool v, int mask) {
  return __shfl_xor_sync(0xffffffffu, static_cast<int>(v), mask) != 0;
}

struct SxRedSum { template <typename T> SX_D T operator()(T a, T b) const { return a + b; } };
struct SxRedProd { template <typename T> SX_D T operator()(T a, T b) const { return a * b; } };
struct SxRedMax { template <typename T> SX_D T operator()(T a, T b) const { return sx_max(a, b); } };
struct SxRedMin { template <typename T> SX_D T operator()(T a, T b) const { return sx_min(a, b); } };

template <typename T, typename Op>
SX_D T sx_warp_allreduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, sx_shfl_xor(v, o));
  return v;
}

// Every thread of the grid waits until all have arrived, and what any of
// them wrote before is then visible to all.  The kernel must be launched by
// cudaLaunchCooperativeKernel, which refuses a grid that cannot be resident
// at once.
SX_D void sx_grid_sync() { cooperative_groups::this_grid().sync(); }
