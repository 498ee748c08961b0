// The attention kernels of repro_torch.kernels: online softmax over the
// keys, f32 inside whatever the element type, GQA by kv head = h / G.
// Scores are q * scale dotted with k, as the Pallas kernels scale q before
// the dot; keys a query may not see are left out, where the Pallas kernels
// give them SX_NEG_INF, whose exp is 0 all the same.
//
// stitched_decode_attention replaces repro/kernels/stitched_attention.py
//   decode_attention (_decode_kernel).
//   Bound by bytes: the valid part of the KV cache is read once per query
//   head, two f32 operations per byte of bf16.  One block per (query head,
//   sequence); the loop over keys inside the block replaces the TPU's
//   sequential KV grid axis.  Each warp walks its own runs of 32 keys: a
//   lane dots one key with q (held scaled in shared memory), the warp's
//   online-softmax state (m, l) moves once per run, and each lane keeps the
//   f32 accumulator of its D/32 dims, so reads of v are coalesced.  The
//   warps' states merge in shared memory at the end.  Keys at positions
//   >= lengths[b] are never read; with lengths[b] == 0 the output is
//   0/0 = NaN, as in the Pallas kernel and the plain version.
//
// stitched_flash_attention replaces repro/kernels/stitched_attention.py
//   flash_attention (_flash_kernel).
//   Bound by operations (4 * D per visible (query, key) pair, about 1.3e10
//   for one causal 2048-token layer of granite-moe), which is where this
//   first version is far from the card: it runs them as f32 FMAs, not on
//   the tensor cores.  One block per (q tile, query head, sequence) and one
//   thread per query row, holding q and the f32 accumulator of its row in
//   registers.  K and V tiles are staged in shared memory as f32 (2 * bk *
//   D * 4 bytes, 64 KB at bk = 128, D = 64: above the 48 KB default, so the
//   launcher raises the kernel's dynamic shared-memory limit first) and
//   every thread reads the same key at the same time, a broadcast.  Scores
//   are taken 16 keys at a time, so the accumulator is rescaled once per 16
//   keys.  Causal tiles wholly above the diagonal are never loaded, and a
//   row stops at its own position.  wgmma and TMA are later work.
//
// Each launcher is extern "C", one per element type, and returns the first
// CUDA error: cudaFuncSetAttribute's, else cudaGetLastError()'s after the
// launch, so a refused launch reaches the Python wrapper.  The head dim D
// is a template argument (8, 16, 32, 64 or 128); any other D is refused
// with cudaErrorInvalidValue.

#include "hand_kernels.cuh"

// ---------------------------------------------------------------- decode
constexpr int SX_DECODE_WARPS = 4;

template <typename T, int D>
__global__ void __launch_bounds__(32 * SX_DECODE_WARPS) sx_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ o, int Hq, int Hkv, int S, float scale) {
  constexpr int DL = (D + 31) / 32;  // accumulator dims a lane holds
  __shared__ float qs[D];
  __shared__ float wm[SX_DECODE_WARPS], wl[SX_DECODE_WARPS];
  __shared__ float wacc[SX_DECODE_WARPS][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const T* qh = q + ((long long)b * Hq + h) * D;
  const long long kv = ((long long)b * Hkv + h / (Hq / Hkv)) * S * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) qs[d] = sx_load(qh + d) * scale;
  __syncthreads();
  const int n = min(max(lengths[b], 0), S);

  float m = SX_NEG_INF, l = 0.0f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.0f;
  for (int base = warp * 32; base < n; base += 32 * SX_DECODE_WARPS) {
    const int j = base + lane;
    float s = SX_NEG_INF;
    if (j < n) {
      const T* kj = k + kv + (long long)j * D;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qs[d] * sx_load(kj + d);
      s = dot;
    }
    const float m_new = sx_max(m, sx_warp_reduce(s, SxMax()));
    const float alpha = expf(m - m_new);
    const float p = j < n ? expf(s - m_new) : 0.0f;
    l = l * alpha + sx_warp_reduce(p, SxSum());
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
    const int run = min(32, n - base);
    for (int jj = 0; jj < run; ++jj) {
      const float pj = __shfl_sync(SX_FULL_MASK, p, jj);
      const T* vj = v + kv + (long long)(base + jj) * D;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += pj * sx_load(vj + d);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) wacc[warp][d] = acc[i];
  }
  __syncthreads();
  T* oh = o + ((long long)b * Hq + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mm = wm[0];
    for (int w = 1; w < SX_DECODE_WARPS; ++w) mm = sx_max(mm, wm[w]);
    float ll = 0.0f, a = 0.0f;
    for (int w = 0; w < SX_DECODE_WARPS; ++w) {
      const float c = expf(wm[w] - mm);
      ll += wl[w] * c;
      a += wacc[w][d] * c;
    }
    sx_store(oh + d, a / ll);
  }
}

template <typename T, int D>
static int sx_decode_launch(const T* q, const T* k, const T* v, const int* lengths, T* o, int B,
                            int Hq, int Hkv, int S, float scale, void* stream) {
  sx_decode_kernel<T, D><<<dim3(Hq, B), 32 * SX_DECODE_WARPS, 0,
                           static_cast<cudaStream_t>(stream)>>>(q, k, v, lengths, o, Hq, Hkv, S,
                                                                scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int sx_decode_dispatch(const T* q, const T* k, const T* v, const int* lengths, T* o, int B,
                              int Hq, int Hkv, int S, int D, float scale, void* stream) {
  switch (D) {
    case 8: return sx_decode_launch<T, 8>(q, k, v, lengths, o, B, Hq, Hkv, S, scale, stream);
    case 16: return sx_decode_launch<T, 16>(q, k, v, lengths, o, B, Hq, Hkv, S, scale, stream);
    case 32: return sx_decode_launch<T, 32>(q, k, v, lengths, o, B, Hq, Hkv, S, scale, stream);
    case 64: return sx_decode_launch<T, 64>(q, k, v, lengths, o, B, Hq, Hkv, S, scale, stream);
    case 128: return sx_decode_launch<T, 128>(q, k, v, lengths, o, B, Hq, Hkv, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sx_decode_attention_f32(const float* q, const float* k, const float* v,
                                       const int* lengths, float* o, int B, int Hq, int Hkv,
                                       int S, int D, float scale, void* stream) {
  return sx_decode_dispatch(q, k, v, lengths, o, B, Hq, Hkv, S, D, scale, stream);
}

extern "C" int sx_decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, const int* lengths,
                                        __nv_bfloat16* o, int B, int Hq, int Hkv, int S, int D,
                                        float scale, void* stream) {
  return sx_decode_dispatch(q, k, v, lengths, o, B, Hq, Hkv, S, D, scale, stream);
}

// ---------------------------------------------------------------- prefill
constexpr int SX_FLASH_CHUNK = 16;  // scores a thread holds between rescales
// Query rows (threads) of a block at most.  q and acc take 2 * D registers
// a thread; a bound of 256 threads leaves the compiler all 255.
constexpr int SX_FLASH_MAX_BQ = 256;

template <typename T, int D>
__global__ void __launch_bounds__(SX_FLASH_MAX_BQ) sx_flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int S, int bk, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char sx_smem[];
  float* ks = reinterpret_cast<float*>(sx_smem);  // bk x D
  float* vs = ks + bk * D;                        // bk x D
  const int bq = blockDim.x;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int qpos = iq * bq + threadIdx.x;
  const long long qrow = (((long long)b * Hq + h) * S + qpos) * D;
  const long long kv = ((long long)b * Hkv + h / (Hq / Hkv)) * S * D;

  float qv[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = sx_load(q + qrow + d) * scale;
    acc[d] = 0.0f;
  }
  float m = SX_NEG_INF, l = 0.0f;
  // the Pallas kernel runs KV tile ik iff ik * bk <= iq * bq + bq - 1
  const int kv_end = causal ? min(S, (iq + 1) * bq) : S;
  for (int k0 = 0; k0 < kv_end; k0 += bk) {
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < bk * D; e += bq) {
      ks[e] = sx_load(k + kv + (long long)k0 * D + e);
      vs[e] = sx_load(v + kv + (long long)k0 * D + e);
    }
    __syncthreads();
    const int n = causal ? min(bk, qpos - k0 + 1) : bk;  // keys of the tile this row sees
    for (int c = 0; c < n; c += SX_FLASH_CHUNK) {
      float s[SX_FLASH_CHUNK];
      float mc = SX_NEG_INF;
#pragma unroll
      for (int u = 0; u < SX_FLASH_CHUNK; ++u) {
        float dot = SX_NEG_INF;
        if (c + u < n) {
          const float* kr = ks + (c + u) * D;
          dot = 0.0f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot += qv[d] * kr[d];
          mc = sx_max(mc, dot);
        }
        s[u] = dot;
      }
      const float m_new = sx_max(m, mc);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int u = 0; u < SX_FLASH_CHUNK; ++u) {
        if (c + u < n) {
          const float p = expf(s[u] - m_new);
          const float* vr = vs + (c + u) * D;
          l += p;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += p * vr[d];
        }
      }
      m = m_new;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) sx_store(o + qrow + d, acc[d] / l);
}

template <typename T, int D>
static int sx_flash_launch(const T* q, const T* k, const T* v, T* o, int B, int Hq, int Hkv,
                           int S, int bq, int bk, int causal, float scale, void* stream) {
  const int smem = static_cast<int>(2 * sizeof(float) * bk * D);
  const cudaError_t err = cudaFuncSetAttribute(
      sx_flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sx_flash_kernel<T, D><<<dim3(S / bq, Hq, B), bq, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, Hq, Hkv, S, bk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int sx_flash_dispatch(const T* q, const T* k, const T* v, T* o, int B, int Hq, int Hkv,
                             int S, int D, int bq, int bk, int causal, float scale,
                             void* stream) {
  switch (D) {
    case 8: return sx_flash_launch<T, 8>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    case 16: return sx_flash_launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    case 32: return sx_flash_launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    case 64: return sx_flash_launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    case 128: return sx_flash_launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sx_flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                      int B, int Hq, int Hkv, int S, int D, int bq, int bk,
                                      int causal, float scale, void* stream) {
  return sx_flash_dispatch(q, k, v, o, B, Hq, Hkv, S, D, bq, bk, causal, scale, stream);
}

extern "C" int sx_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, __nv_bfloat16* o, int B, int Hq,
                                       int Hkv, int S, int D, int bq, int bk, int causal,
                                       float scale, void* stream) {
  return sx_flash_dispatch(q, k, v, o, B, Hq, Hkv, S, D, bq, bk, causal, scale, stream);
}
