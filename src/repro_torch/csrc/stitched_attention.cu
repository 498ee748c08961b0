// The attention kernels of repro_torch.kernels: online softmax over the
// keys, f32 sums whatever the element type, GQA by kv head = h / G.  Scores
// are the f32 dot of q and k times the scale (the Pallas kernels scale q in
// f32 first, which rounds the same to within an ulp); keys a query may not
// see get SX_NEG_INF, as in the Pallas kernels, or are left out.
//
// stitched_decode_attention replaces repro/kernels/stitched_attention.py
//   decode_attention (_decode_kernel).
//   Bound by bytes: two f32 operations per byte of bf16 K and V, far under
//   the card's 295 operations per byte, so it stays on the CUDA cores and
//   the design is about the bytes read.  Two kernels, one after the other
//   on the stream.  sx_decode_split_kernel: one block per (split of
//   `split` keys, kv head, sequence); the loop over keys inside the block
//   replaces the TPU's sequential KV grid axis, and the splits spread one
//   long cache over many SMs.  A block serves all G query heads of its kv
//   head, so each valid key and value row is read from device memory
//   once.  Rows are read with 16-byte loads by groups of D / 8 (bf16, f16)
//   or D / 4 (f32) neighbouring lanes, the dot partials reduced by shuffles
//   in the group.  The split's scores go to shared memory, its max and sum are
//   taken once, and a second pass over V sums p * v; each block writes
//   (acc[D], m, l) per query head to f32 scratch.  A split that starts at
//   or past lengths[b] writes only m = SX_NEG_INF, l = 0.
//   sx_decode_combine_kernel: one block per (query head, sequence) merges
//   the splits whose l is not 0; with lengths[b] == 0 that is none and the
//   output is 0/0 = NaN, as in the Pallas kernel and the plain version.
//
// stitched_flash_attention replaces repro/kernels/stitched_attention.py
//   flash_attention (_flash_kernel).
//   Bound by operations: 4 * D per visible (query, key) pair, about 1.3e10
//   for one causal 2048-token layer of granite-moe, 13 us at the tensor
//   cores' 989 TFLOP/s bf16.  P goes into O += P V as two terms of T, hi =
//   T(p) and lo = T(p - hi), two products instead of one: with hi alone
//   each bf16 weight moves by up to 2^-9 of itself, which moves outputs
//   near 0 past the full-width limit of 1e-2 |o| + 1e-4
//   (tests/test_torch_kernels.py pins that), and the two terms keep about
//   16 bits of p.  So the tensor work is 1.5 times the bound's.  l sums the
//   f32 p.  The wrapper picks one of three kernels by dtype and D before
//   the launch.
//   bf16 and f16 at D = 64 and 128, sx_flash_wgmma_kernel<T, D>: a block
//   of three warpgroups owns 128 query rows of one (query head, sequence).
//   The producer warpgroup gives up its registers (setmaxnreg 24) and one
//   of its threads loads Q once and K and V tiles of 128 keys by TMA
//   (tensor maps built by the launcher, the driver's cuTensorMapEncodeTiled
//   reached through cudaGetDriverEntryPoint, so the library needs no
//   -lcuda) into a ring of three stages, each tile as 64-column panels in
//   the 128-byte swizzle, full and empty mbarriers between it and the two
//   consumer warpgroups (setmaxnreg 240) of 64 rows each.  S = Q K^T is
//   wgmma m64n128k16 from shared memory (K-major Q and K); O += P V is
//   wgmma m64nDk16 with P's hi and lo terms from registers and V MN-major
//   (transposed) in shared memory.  Step j issues S_j and the P V of tile
//   j - 1 back to back and then runs the softmax of S_j; named barriers
//   hand the tensor cores from one consumer to the other, so one's softmax
//   runs while the other's products do.  The softmax takes each row's max
//   and sum as trees (no dependency chain the length of a row), exp2 on
//   the special-function unit, and s * scale log2(e) - m as one FMA.
//   What bounds it on this card is that softmax, not the products or the
//   loads: 64 exp2s and the hi + lo packing of 64 weights a thread per
//   tile, issued by one warp a scheduler for each consumer, whose latency
//   nothing else hides; the registers (S 64, O up to 64, P's two terms 64 a
//   thread) leave no room for a second S in flight or a third consumer.
//   Causal tiles wholly above the diagonal are never loaded, the diagonal
//   tile is masked, the heaviest q tiles launch first; TMA zero-fills rows
//   past S, and keys past S are masked.
//   An earlier wgmma attempt, fed by cp.async, agreed at D = 128 and failed
//   at D = 64 past one KV tile; its code was withdrawn and is not in this
//   repository, so the fault cannot be read back.  This kernel closes the two places it could
//   lie: every stage, panel and consumer's rows start on a 1024-byte swizzle
//   atom (static_asserts in SxWgTile), and each wgmma batch is preceded by
//   wgmma.fence after the O rescale and the P packing, with the registers
//   pinned (sx_pin) so the compiler moves no read of S or O above
//   wgmma.wait_group and no write of O or P below the wgmma that reads
//   it.  D = 64 past many tiles agrees (chip_smoke.py phase 6).
//   bf16 and f16 at D = 8, 16 and 32, sx_flash_mma_kernel<T, D>: both
//   products on mma.sync m16n8k16 (the .f16 form for f16, the same tiles).
//   One block of 4 warps owns 64 query rows of one (query head, sequence),
//   16 rows a warp; q fragments are loaded once.  K and V tiles of 64 keys
//   stay in shared memory, two stages filled by 16-byte cp.async while the
//   previous tile computes; rows are padded by 16 bytes so ldmatrix's eight
//   row addresses fall in distinct banks.  S = Q K^T per warp in registers,
//   the online softmax per row in registers (a row's max by shuffles among
//   the 4 lanes that hold it), P taken straight from the S accumulators
//   into the A fragments of O += P V, V read through ldmatrix.trans.  The
//   same causal skipping and order; D = 8 runs as D = 16 with zero columns
//   in shared memory; rows past S are zero-filled and masked.
//   f32, sx_flash_kernel: tensor cores at f32 would mean TF32 and move
//   results past the f32 limits, so f32 keeps the first design: f32 FMAs, one
//   block per (q tile, query head, sequence) and one thread per query row,
//   K and V tiles staged as f32 in shared memory (64 KB at bk = 128, D =
//   64: above the 48 KB default, so the launcher raises the kernel's
//   dynamic shared-memory limit first), scores taken 16 keys at a time.
//
// Each launcher is extern "C", one per element type, and returns the first
// CUDA error: cudaFuncSetAttribute's, else cudaGetLastError()'s after the
// launch, so a refused launch reaches the Python wrapper.  The head dim D
// is a template argument (8, 16, 32, 64 or 128; the wgmma launchers take
// 64 and 128, the mma.sync ones 8, 16 and 32); any other D is refused with
// cudaErrorInvalidValue.

#include <cuda.h>

#include <atomic>

#include "hand_kernels.cuh"

// ---------------------------------------------------------------- decode
constexpr int SX_DECODE_WARPS = 4;
constexpr int SX_DECODE_MAX_SPLIT = 256;  // keys of one split at most
constexpr int SX_DECODE_UNROLL = 4;       // rows a lane group loads before it uses them

// part is (B, Hq, nsplit, D + 2) f32: the split's unnormalised acc[D], its
// max m and its sum l, for each query head.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(32 * SX_DECODE_WARPS) sx_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ part, int Hq, int Hkv, int S, int split,
    float scale) {
  constexpr int VEC = 16 / sizeof(T);         // elements of one 16-byte load
  constexpr int LPR = D / VEC;                // lanes that read one row
  constexpr int ROWS = 32 * SX_DECODE_WARPS / LPR;  // rows the block reads at once
  constexpr int STEP = ROWS * SX_DECODE_UNROLL;
  __shared__ float ps[GM][SX_DECODE_MAX_SPLIT];      // scores, then p
  __shared__ float red[SX_DECODE_WARPS][GM][D];      // the warps' partial acc
  __shared__ float ms[GM], ls[GM];
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int grp = threadIdx.x / LPR, sub = threadIdx.x % LPR;
  const int n = min(max(lengths[b], 0), S);
  const int start = sp * split;
  const int cnt = min(split, n - start);
  const long long row_stride = (long long)nsplit * (D + 2);  // one query head to the next
  float* pb = part + (((long long)b * Hq + kvh * G) * nsplit + sp) * (D + 2);
  if (cnt <= 0) {
    for (int i = threadIdx.x; i < G; i += blockDim.x) {
      pb[i * row_stride + D] = SX_NEG_INF;
      pb[i * row_stride + D + 1] = 0.0f;
    }
    return;
  }
  const long long kv = (((long long)b * Hkv + kvh) * S + start) * D + sub * VEC;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int h0 = 0; h0 < G; h0 += GM) {  // GM query heads at a time
    const int gc = min(GM, G - h0);
    const T* qh = q + ((long long)b * Hq + kvh * G + h0) * D + sub * VEC;
    float qv[GM][VEC];
#pragma unroll
    for (int i = 0; i < GM; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[i][e] = i < gc ? sx_load(qh + i * D + e) : 0.0f;

    // pass 1: the split's scores, one row per lane group at a time
    for (int r0 = 0; r0 < cnt; r0 += STEP) {
      uint4 raw[SX_DECODE_UNROLL];
#pragma unroll
      for (int u = 0; u < SX_DECODE_UNROLL; ++u) {
        const int j = r0 + u * ROWS + grp;
        raw[u] = j < cnt ? *reinterpret_cast<const uint4*>(k + kv + (long long)j * D) : zero;
      }
#pragma unroll
      for (int u = 0; u < SX_DECODE_UNROLL; ++u) {
        const int j = r0 + u * ROWS + grp;
        float kf[VEC];
        SxVec16<T>::unpack(raw[u], kf);
#pragma unroll
        for (int i = 0; i < GM; ++i) {
          float dot = 0.0f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot += qv[i][e] * kf[e];
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(SX_FULL_MASK, dot, o);
          if (sub == 0 && j < cnt && i < gc) ps[i][j] = dot * scale;
        }
      }
    }
    __syncthreads();

    // the split's max and sum of each head, a warp per head
    for (int i = warp; i < gc; i += SX_DECODE_WARPS) {
      float m = SX_NEG_INF;
      for (int j = lane; j < cnt; j += 32) m = sx_max(m, ps[i][j]);
      m = sx_warp_reduce(m, SxMax());
      float l = 0.0f;
      for (int j = lane; j < cnt; j += 32) {
        const float p = expf(ps[i][j] - m);
        ps[i][j] = p;
        l += p;
      }
      l = sx_warp_reduce(l, SxSum());
      if (lane == 0) {
        ms[i] = m;
        ls[i] = l;
      }
    }
    __syncthreads();

    // pass 2: acc = sum of p * v over the split, this lane's VEC dims
    float acc[GM][VEC];
#pragma unroll
    for (int i = 0; i < GM; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = 0.0f;
    for (int r0 = 0; r0 < cnt; r0 += STEP) {
      uint4 raw[SX_DECODE_UNROLL];
#pragma unroll
      for (int u = 0; u < SX_DECODE_UNROLL; ++u) {
        const int j = r0 + u * ROWS + grp;
        raw[u] = j < cnt ? *reinterpret_cast<const uint4*>(v + kv + (long long)j * D) : zero;
      }
#pragma unroll
      for (int u = 0; u < SX_DECODE_UNROLL; ++u) {
        const int j = r0 + u * ROWS + grp;
        if (j < cnt) {
          float vf[VEC];
          SxVec16<T>::unpack(raw[u], vf);
#pragma unroll
          for (int i = 0; i < GM; ++i) {
            const float p = i < gc ? ps[i][j] : 0.0f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] += p * vf[e];
          }
        }
      }
    }
    // sum over the lane groups of a warp, then over the warps
#pragma unroll
    for (int i = 0; i < GM; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) acc[i][e] += __shfl_xor_sync(SX_FULL_MASK, acc[i][e], o);
    if (lane < LPR) {
#pragma unroll
      for (int i = 0; i < GM; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[warp][i][sub * VEC + e] = acc[i][e];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < gc * D; x += blockDim.x) {
      const int i = x / D, d = x % D;
      float a = red[0][i][d];
      for (int w = 1; w < SX_DECODE_WARPS; ++w) a += red[w][i][d];
      pb[(h0 + i) * row_stride + d] = a;
    }
    for (int i = threadIdx.x; i < gc; i += blockDim.x) {
      pb[(h0 + i) * row_stride + D] = ms[i];
      pb[(h0 + i) * row_stride + D + 1] = ls[i];
    }
    __syncthreads();  // ps, red, ms and ls are free for the next head group
  }
}

// One block per (query head, sequence), a thread per dim: the splits merged
// by their max.  Splits with l == 0 hold no keys and are left out (l is NaN,
// not 0, where the scores were NaN, and then the output is NaN too).
template <typename T>
__global__ void sx_decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o, int D,
                                         int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, Hq = gridDim.x;
  const float* pb = part + ((long long)b * Hq + h) * nsplit * (D + 2);
  float m = SX_NEG_INF;
  for (int s = 0; s < nsplit; ++s) {
    if (pb[s * (D + 2) + D + 1] != 0.0f) m = sx_max(m, pb[s * (D + 2) + D]);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const float* ps = pb + s * (D + 2);
      if (ps[D + 1] != 0.0f) {
        const float c = expf(ps[D] - m);
        l += ps[D + 1] * c;
        a += ps[d] * c;
      }
    }
    sx_store(o + ((long long)b * Hq + h) * D + d, a / l);
  }
}

template <typename T, int D>
static int sx_decode_split_launch(const T* q, const T* k, const T* v, const int* lengths,
                                  float* part, int B, int Hq, int Hkv, int S, int split,
                                  int nsplit, float scale, void* stream) {
  const dim3 grid(nsplit, Hkv, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hq / Hkv <= 4) {
    sx_decode_split_kernel<T, D, 4><<<grid, 32 * SX_DECODE_WARPS, 0, st>>>(
        q, k, v, lengths, part, Hq, Hkv, S, split, scale);
  } else {
    sx_decode_split_kernel<T, D, 8><<<grid, 32 * SX_DECODE_WARPS, 0, st>>>(
        q, k, v, lengths, part, Hq, Hkv, S, split, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int sx_decode_split_dispatch(const T* q, const T* k, const T* v, const int* lengths,
                                    float* part, int B, int Hq, int Hkv, int S, int D, int split,
                                    int nsplit, float scale, void* stream) {
  if (split < 1 || split > SX_DECODE_MAX_SPLIT || (long long)split * nsplit < S)
    return static_cast<int>(cudaErrorInvalidValue);
#define SX_DECODE_CASE(DD)                                                                      \
  case DD:                                                                                      \
    return sx_decode_split_launch<T, DD>(q, k, v, lengths, part, B, Hq, Hkv, S, split, nsplit, \
                                         scale, stream);
  switch (D) {
    SX_DECODE_CASE(8)
    SX_DECODE_CASE(16)
    SX_DECODE_CASE(32)
    SX_DECODE_CASE(64)
    SX_DECODE_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SX_DECODE_CASE
}

template <typename T>
static int sx_decode_combine_launch(const float* part, T* o, int B, int Hq, int D, int nsplit,
                                    void* stream) {
  sx_decode_combine_kernel<T><<<dim3(Hq, B), D < 32 ? 32 : D, 0,
                                static_cast<cudaStream_t>(stream)>>>(part, o, D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sx_decode_split_f32(const float* q, const float* k, const float* v,
                                   const int* lengths, float* part, int B, int Hq, int Hkv, int S,
                                   int D, int split, int nsplit, float scale, void* stream) {
  return sx_decode_split_dispatch(q, k, v, lengths, part, B, Hq, Hkv, S, D, split, nsplit, scale,
                                  stream);
}

extern "C" int sx_decode_split_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, const int* lengths, float* part,
                                    int B, int Hq, int Hkv, int S, int D, int split, int nsplit,
                                    float scale, void* stream) {
  return sx_decode_split_dispatch(q, k, v, lengths, part, B, Hq, Hkv, S, D, split, nsplit, scale,
                                  stream);
}

extern "C" int sx_decode_split_f16(const __half* q, const __half* k,
                                    const __half* v, const int* lengths, float* part,
                                    int B, int Hq, int Hkv, int S, int D, int split, int nsplit,
                                    float scale, void* stream) {
  return sx_decode_split_dispatch(q, k, v, lengths, part, B, Hq, Hkv, S, D, split, nsplit, scale,
                                  stream);
}

extern "C" int sx_decode_combine_f32(const float* part, float* o, int B, int Hq, int D,
                                     int nsplit, void* stream) {
  return sx_decode_combine_launch(part, o, B, Hq, D, nsplit, stream);
}

extern "C" int sx_decode_combine_bf16(const float* part, __nv_bfloat16* o, int B, int Hq, int D,
                                      int nsplit, void* stream) {
  return sx_decode_combine_launch(part, o, B, Hq, D, nsplit, stream);
}

extern "C" int sx_decode_combine_f16(const float* part, __half* o, int B, int Hq, int D,
                                      int nsplit, void* stream) {
  return sx_decode_combine_launch(part, o, B, Hq, D, nsplit, stream);
}

// ------------------------------------------------------- prefill, bf16 and f16 on the tensor cores
constexpr int SX_MMA_WARPS = 4;
constexpr int SX_MMA_ROWS = 16 * SX_MMA_WARPS;  // query rows of a block, and keys of a tile
constexpr float SX_LOG2E = 1.4426950408889634f;

template <int D>
struct SxMmaTile {
  static constexpr int DP = D < 16 ? 16 : D;  // the mma's k is 16: D = 8 gets 8 zero columns
  static constexpr int LD = DP + 8;           // row stride in elements: 16 bytes of padding
  static constexpr int ELEMS = SX_MMA_ROWS * LD;
  static constexpr int SMEM = 5 * ELEMS * 2;  // Q, and two stages of K and V, in bytes
};

// Rows r0 .. r0 + 63 of a (S, D) bf16 or f16 matrix into a tile, 16 bytes a
// copy; rows at or past S are zero-filled.
template <typename T, int D>
SX_D void sx_mma_load_tile(T* tile, const T* src, int r0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  for (int c = threadIdx.x; c < SX_MMA_ROWS * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = r0 + r < S;
    sx_cp_async16(tile + r * SxMmaTile<D>::LD + col, src + (long long)(ok ? r0 + r : 0) * D + col,
                  ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * SX_MMA_WARPS) sx_flash_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int S, int causal, float scale_log2) {
  using Tile = SxMmaTile<D>;
  constexpr int LD = Tile::LD, KS = Tile::DP / 16, NO = Tile::DP / 8;
  extern __shared__ __align__(16) unsigned char sx_smem[];
  T* qs = reinterpret_cast<T*>(sx_smem);
  T* ks = qs + Tile::ELEMS;      // two stages
  T* vs = ks + 2 * Tile::ELEMS;  // two stages
  const int iq = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int q0 = iq * SX_MMA_ROWS;
  const T* qh = q + ((long long)b * Hq + h) * S * D;
  const long long kv = ((long long)b * Hkv + h / (Hq / Hkv)) * S * D;
  const int n_kv = causal ? iq + 1 : (S + SX_MMA_ROWS - 1) / SX_MMA_ROWS;

  if (D < 16) {  // the pad columns of all five tiles; no copy writes them
    for (int r = threadIdx.x; r < 5 * SX_MMA_ROWS; r += blockDim.x)
      *reinterpret_cast<uint4*>(qs + r * LD + 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  sx_mma_load_tile<T, D>(qs, qh, q0, S);
  sx_cp_async_commit();
  sx_mma_load_tile<T, D>(ks, k + kv, 0, S);
  sx_mma_load_tile<T, D>(vs, v + kv, 0, S);
  sx_cp_async_commit();
  sx_cp_async_wait<1>();
  __syncthreads();
  // A fragments of this warp's 16 rows of q: rows (lane % 8) + 8 * (lane / 8 % 2), columns
  // 8 * (lane / 16) of each 16-column step
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    sx_ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                               (lane >> 4) * 8);

  float of[NO][4], m[2] = {SX_NEG_INF, SX_NEG_INF}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nd = 0; nd < NO; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) of[nd][i] = 0.0f;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  for (int j = 0; j < n_kv; ++j) {
    const T* kt = ks + (j & 1) * Tile::ELEMS;
    const T* vt = vs + (j & 1) * Tile::ELEMS;
    if (j + 1 < n_kv) {  // the next tile into the other stage, while this one computes
      sx_mma_load_tile<T, D>(ks + ((j + 1) & 1) * Tile::ELEMS, k + kv, (j + 1) * SX_MMA_ROWS, S);
      sx_mma_load_tile<T, D>(vs + ((j + 1) & 1) * Tile::ELEMS, v + kv, (j + 1) * SX_MMA_ROWS, S);
      sx_cp_async_commit();
      sx_cp_async_wait<1>();
    } else {
      sx_cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys.  ldmatrix gives the B fragments of two key tiles:
    // keys (lane % 8) + 8 * (lane / 16), columns 8 * (lane / 8 % 2) of the step
    float sf[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sf[nt][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kb[4];
        sx_ldmatrix_x4(kb, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8);
        const unsigned b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
        sx_mma_16816<T>(sf[2 * np], qf[kk], b0);
        sx_mma_16816<T>(sf[2 * np + 1], qf[kk], b1);
      }
    }

    // scores in log2 units; the diagonal tile and keys past S masked
    const int k0 = j * SX_MMA_ROWS;
    const bool edge = (causal && j == iq) || k0 + SX_MMA_ROWS > S;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1), row = row0 + (i >> 1) * 8;
        const bool hidden = edge && (key >= S || (causal && key > row));
        sf[nt][i] = hidden ? SX_NEG_INF : sf[nt][i] * scale_log2;
      }
    }

    // online softmax of rows row0 (r = 0) and row0 + 8 (r = 1), each held by 4 lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = sx_max(mx, sx_max(sf[nt][2 * r], sf[nt][2 * r + 1]));
      mx = sx_max(mx, __shfl_xor_sync(SX_FULL_MASK, mx, 1));
      mx = sx_max(mx, __shfl_xor_sync(SX_FULL_MASK, mx, 2));
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int nd = 0; nd < NO; ++nd) {
        of[nd][2 * r] *= alpha;
        of[nd][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(sf[nt][2 * r + c] - mx);
          sf[nt][2 * r + c] = p;
          l[r] += p;  // this lane's part of the row sum, from the f32 p
        }
      }
    }

    // O += P V, P as two bf16 terms: hi = bf16(p) and lo = bf16(p - hi).  The S
    // accumulators of key tiles 2kk and 2kk + 1 are the A fragments of step kk;
    // ldmatrix.trans gives the B fragments of two dim tiles: keys (lane % 8) +
    // 8 * (lane / 8 % 2) of the step, dims 8 * (lane / 16)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ph[4], pl[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // registers of rows g, g + 8 (x % 2), key tile 2kk + x / 2
        const float* pp = &sf[2 * kk + x / 2][2 * (x % 2)];
        ph[x] = SxPair<T>::pack(pp[0], pp[1]);
        pl[x] = SxPair<T>::pack(pp[0] - SxPair<T>::lo(ph[x]), pp[1] - SxPair<T>::hi(ph[x]));
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned vb[4];
        sx_ldmatrix_x4_trans(vb, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                     np * 16 + (lane >> 4) * 8);
        const unsigned b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        sx_mma_16816<T>(of[2 * np], ph, b0);
        sx_mma_16816<T>(of[2 * np + 1], ph, b1);
        sx_mma_16816<T>(of[2 * np], pl, b0);
        sx_mma_16816<T>(of[2 * np + 1], pl, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(SX_FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(SX_FULL_MASK, l[r], 2);
  }
  T* oh = o + ((long long)b * Hq + h) * S * D;
#pragma unroll
  for (int nd = 0; nd < NO; ++nd) {
    const int col = nd * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (col < D && row < S) {
        *reinterpret_cast<unsigned*>(oh + (long long)row * D + col) =
            SxPair<T>::pack(of[nd][2 * r] / l[r], of[nd][2 * r + 1] / l[r]);
      }
    }
  }
}

template <typename T, int D>
static int sx_flash_mma_launch(const T* q, const T* k, const T* v, T* o, int B, int Hq, int Hkv,
                               int S, int causal, float scale, void* stream) {
  const int smem = SxMmaTile<D>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      sx_flash_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sx_flash_mma_kernel<T, D><<<dim3((S + SX_MMA_ROWS - 1) / SX_MMA_ROWS, Hq, B), 32 * SX_MMA_WARPS,
                           smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, o, Hq, Hkv, S,
                                                                      causal, scale * SX_LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int sx_flash_mma_dispatch(const T* q, const T* k, const T* v, T* o, int B, int Hq, int Hkv,
                                 int S, int D, int causal, float scale, void* stream) {
  switch (D) {
    case 8: return sx_flash_mma_launch<T, 8>(q, k, v, o, B, Hq, Hkv, S, causal, scale, stream);
    case 16: return sx_flash_mma_launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, causal, scale, stream);
    case 32: return sx_flash_mma_launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);  // D = 64 and 128 run on wgmma
  }
}

extern "C" int sx_flash_mma_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, __nv_bfloat16* o, int B, int Hq,
                                           int Hkv, int S, int D, int causal, float scale,
                                           void* stream) {
  return sx_flash_mma_dispatch(q, k, v, o, B, Hq, Hkv, S, D, causal, scale, stream);
}

extern "C" int sx_flash_mma_attention_f16(const __half* q, const __half* k, const __half* v,
                                          __half* o, int B, int Hq, int Hkv, int S, int D,
                                          int causal, float scale, void* stream) {
  return sx_flash_mma_dispatch(q, k, v, o, B, Hq, Hkv, S, D, causal, scale, stream);
}

// ------------------------------------------- prefill, bf16 and f16 on wgmma and TMA
constexpr int SX_WG_BQ = 128;             // query rows of a block: two consumer warpgroups of 64
constexpr int SX_WG_BK = 128;             // keys of a K or V tile
constexpr int SX_WG_STAGES = 3;           // K and V tiles in flight
constexpr int SX_WG_THREADS = 3 * 128;    // a producer warpgroup and two consumers
constexpr int SX_WG_CONSUMERS = 2 * 128;  // arrivals that free a stage
constexpr int SX_WG_PANEL = 64;           // elements of one 128-byte swizzled row
constexpr int SX_WG_TURN = 1;             // named barriers 1 and 2: each consumer's turn
// registers a thread: 24 for the producer, 240 for the consumers (the
// launch's 168 each, 384 x 168 = 64,512 of the SM's 65,536, moved over)
constexpr int SX_WG_PRODUCER_REGS = 24;
constexpr int SX_WG_CONSUMER_REGS = 240;

// Shared memory of the wgmma kernel, from a 1024-byte aligned base: Q, the
// K stages, the V stages, then the mbarriers.  Each tile is stored as D / 64
// panels of 64 columns, a panel's rows 128 bytes each in the 128-byte swizzle
// that TMA writes and wgmma reads.
template <int D>
struct SxWgTile {
  static constexpr int PANELS = D / SX_WG_PANEL;
  static constexpr int Q_PANEL = SX_WG_BQ * 128;   // bytes of one panel of Q
  static constexpr int KV_PANEL = SX_WG_BK * 128;  // bytes of one panel of a K or V tile
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + SX_WG_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + SX_WG_STAGES * KV_BYTES;
  static constexpr int BARS = 1 + 3 * SX_WG_STAGES;  // q_full, k_full[], v_full[], empty[]
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * BARS;
  static_assert(D % SX_WG_PANEL == 0, "D is a multiple of 64");
  static_assert(SMEM <= 232448, "a block's shared memory on Hopper");
  static_assert(Q_PANEL % 1024 == 0 && KV_PANEL % 1024 == 0 && (64 * 128) % 1024 == 0,
                "every panel, stage and consumer's rows start on a 1024-byte swizzle atom");
};

// v[0] = op over v[0 .. 2 W - 1], as a tree of depth log2(2 W): v[i] = op(v[i], v[i + W]),
// then the same over the first W
template <int W, typename Op>
SX_D void sx_fold(float* v, Op op) {
  if constexpr (W > 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = op(v[i], v[i + W]);
    sx_fold<W / 2>(v, op);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(SX_WG_THREADS, 1) sx_flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, T* __restrict__ o, int Hq, int Hkv, int S,
    int causal, float scale_log2) {
  using Tile = SxWgTile<D>;
  constexpr int ST = SX_WG_STAGES;
  extern __shared__ __align__(16) unsigned char sx_wg_smem[];
  const unsigned base = (sx_smem_addr(sx_wg_smem) + 1023u) & ~1023u;
  const unsigned qs = base, ks = base + Tile::K_OFF, vs = base + Tile::V_OFF;
  const unsigned q_full = base + Tile::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + ST + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * ST + s); };
  const int iq = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * SX_WG_BQ;
  const int n_kv = causal ? iq + 1 : (S + SX_WG_BK - 1) / SX_WG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sx_mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      sx_mbar_init(k_full(s), 1);
      sx_mbar_init(v_full(s), 1);
      sx_mbar_init(empty(s), SX_WG_CONSUMERS);
    }
    sx_mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads of K and V in flight
    sx_setmaxnreg_dec<SX_WG_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      sx_tma_prefetch(&qmap);
      sx_tma_prefetch(&kmap);
      sx_tma_prefetch(&vmap);
      const int kvz = b * Hkv + h / (Hq / Hkv);
      sx_mbar_expect_tx(q_full, Tile::Q_BYTES);
      for (int p = 0; p < Tile::PANELS; ++p)
        sx_tma_load_3d(qs + p * Tile::Q_PANEL, &qmap, q_full, p * SX_WG_PANEL, q0, b * Hq + h);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % ST;
        if (j >= ST) sx_mbar_wait(empty(s), ((j / ST) & 1) ^ 1);  // its last tile is consumed
        sx_mbar_expect_tx(k_full(s), Tile::KV_BYTES);
        for (int p = 0; p < Tile::PANELS; ++p)
          sx_tma_load_3d(ks + s * Tile::KV_BYTES + p * Tile::KV_PANEL, &kmap, k_full(s),
                         p * SX_WG_PANEL, j * SX_WG_BK, kvz);
        sx_mbar_expect_tx(v_full(s), Tile::KV_BYTES);
        for (int p = 0; p < Tile::PANELS; ++p)
          sx_tma_load_3d(vs + s * Tile::KV_BYTES + p * Tile::KV_PANEL, &vmap, v_full(s),
                         p * SX_WG_PANEL, j * SX_WG_BK, kvz);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows q0 + 64 c .. q0 + 64 c + 63
  sx_setmaxnreg_inc<SX_WG_CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32, lane = tid & 31, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * c + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  const unsigned qc = qs + 64 * c * 128;         // this warpgroup's 64 rows of each Q panel
  float of[D / 2], m[2] = {SX_NEG_INF, SX_NEG_INF}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) of[i] = 0.0f;
  float sf[SX_WG_BK / 2];
  // P of the previous tile as two terms of T, hi = T(p) and lo = T(p - hi),
  // in the A fragments of its 16-key steps
  unsigned ph[SX_WG_BK / 16][4], pl[SX_WG_BK / 16][4];

  // S = Q K_j^T: K-major Q and K, 16 columns of D a step (32 bytes into a
  // panel's swizzled row, the next panel every 4 steps)
  auto issue_s = [&](int j) {
    const unsigned kt = ks + (j % ST) * Tile::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const unsigned step = (kk % 4) * 32;
      const uint64_t da = sx_wgmma_desc(qc + (kk / 4) * Tile::Q_PANEL + step, 16, 1024);
      const uint64_t db = sx_wgmma_desc(kt + (kk / 4) * Tile::KV_PANEL + step, 16, 1024);
      SxWgmma<T, SX_WG_BK>::ss(sf, da, db, kk > 0);
    }
  };
  // O += P V_j: V is MN-major (rows are keys, D contiguous), 16 keys a step
  // (two 1024-byte atoms of 8 keys), the next 64 columns of D a panel away;
  // P's hi and lo terms one product each
  auto issue_pv = [&](int j) {
    const unsigned vt = vs + (j % ST) * Tile::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < SX_WG_BK / 16; ++kk) {
      const uint64_t dv = sx_wgmma_desc(vt + kk * 16 * 128, Tile::KV_PANEL, 1024);
      SxWgmma<T, D>::rs(of, ph[kk], dv);
      SxWgmma<T, D>::rs(of, pl[kk], dv);
    }
  };
  // this warpgroup's turn on the tensor cores: the products' registers
  // settled, then the fence before wgmma reads them
  auto begin_turn = [&]() {
    sx_bar_sync(SX_WG_TURN + c, SX_WG_CONSUMERS);
    sx_pin(of);
#pragma unroll
    for (int kk = 0; kk < SX_WG_BK / 16; ++kk) {
      sx_pin(ph[kk]);
      sx_pin(pl[kk]);
    }
    sx_wgmma_fence();  // the rescaled O and the packed P are written by other instructions
  };
  // the softmax of S_j: O and l rescaled, P_j packed
  auto softmax = [&](int j) {
    // keys past S and, on the diagonal, past the row masked (the test is
    // the same for the whole warpgroup)
    const int k0 = j * SX_WG_BK;
    if ((causal && k0 + SX_WG_BK - 1 > q0 + 64 * c) || k0 + SX_WG_BK > S) {
#pragma unroll
      for (int i = 0; i < SX_WG_BK / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1), row = row0 + 8 * ((i >> 1) & 1);
        if (key >= S || (causal && key > row)) sf[i] = SX_NEG_INF;
      }
    }
    // online softmax of rows row0 (r = 0) and row0 + 8 (r = 1), each held
    // by 4 lanes, both rows at once; maxima and sums taken as trees, so no
    // chain of dependent instructions runs the length of a row.  Scores
    // are in log2 units, s * scale_log2: the maximum of the scaled scores
    // is the scaled maximum (the scale is positive), and exp2 takes
    // s * scale_log2 - m as one FMA.
    float v[2][SX_WG_BK / 8], mx[2], alpha[2];
#pragma unroll
    for (int n8 = 0; n8 < SX_WG_BK / 8; ++n8)
#pragma unroll
      for (int r = 0; r < 2; ++r) v[r][n8] = sx_fmax_nan(sf[4 * n8 + 2 * r], sf[4 * n8 + 2 * r + 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sx_fold<SX_WG_BK / 16>(v[r], [](float a, float b) { return sx_fmax_nan(a, b); });
      mx[r] = sx_fmax_nan(m[r], v[r][0] * scale_log2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = sx_fmax_nan(mx[r], __shfl_xor_sync(SX_FULL_MASK, mx[r], 1));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = sx_fmax_nan(mx[r], __shfl_xor_sync(SX_FULL_MASK, mx[r], 2));
      alpha[r] = sx_exp2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < SX_WG_BK / 2; ++i) sf[i] = sx_exp2(fmaf(sf[i], scale_log2, -mx[(i >> 1) & 1]));
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 4; ++i) of[4 * n8 + i] *= alpha[i >> 1];
#pragma unroll
    for (int n8 = 0; n8 < SX_WG_BK / 8; ++n8)
#pragma unroll
      for (int r = 0; r < 2; ++r) v[r][n8] = sf[4 * n8 + 2 * r] + sf[4 * n8 + 2 * r + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sx_fold<SX_WG_BK / 16>(v[r], [](float a, float b) { return a + b; });
      l[r] = l[r] * alpha[r] + v[r][0];  // this lane's part of the row sum, from the f32 p
    }
    // P's A fragments: registers x = 0..3 of step kk are accumulators
    // 8 kk + 2 x and 8 kk + 2 x + 1 (key tiles 2 kk and 2 kk + 1, rows g and g + 8)
#pragma unroll
    for (int kk = 0; kk < SX_WG_BK / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p0 = sf[8 * kk + 2 * x], p1 = sf[8 * kk + 2 * x + 1];
        ph[kk][x] = SxPair<T>::pack(p0, p1);
        pl[kk][x] = SxPair<T>::pack(p0 - SxPair<T>::lo(ph[kk][x]), p1 - SxPair<T>::hi(ph[kk][x]));
      }
    }
  };

  // Step j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} back to back, hands
  // the tensor cores to the other warpgroup (named barriers SX_WG_TURN + c),
  // and runs the softmax of S_j while they work: the two warpgroups'
  // products and softmaxes alternate.  Step 0 has no P V, the last step
  // (n_kv) no S.
  sx_mbar_wait(q_full, 0);
  if (c == 1) sx_bar_arrive(SX_WG_TURN, SX_WG_CONSUMERS);  // warpgroup 0 issues first
  sx_mbar_wait(k_full(0), 0);
  begin_turn();
  issue_s(0);
  sx_wgmma_commit();
  sx_bar_arrive(SX_WG_TURN + 1 - c, SX_WG_CONSUMERS);
  sx_wgmma_wait<0>();
  sx_pin(sf);
  softmax(0);
  for (int j = 1; j < n_kv; ++j) {
    sx_mbar_wait(k_full(j % ST), (j / ST) & 1);
    sx_mbar_wait(v_full((j - 1) % ST), ((j - 1) / ST) & 1);
    begin_turn();
    issue_s(j);
    issue_pv(j - 1);
    sx_wgmma_commit();
    sx_bar_arrive(SX_WG_TURN + 1 - c, SX_WG_CONSUMERS);
    sx_wgmma_wait<0>();
    sx_pin(sf);
    sx_pin(of);
    sx_mbar_arrive(empty((j - 1) % ST));  // this thread is done with tile j - 1
    softmax(j);
  }
  sx_mbar_wait(v_full((n_kv - 1) % ST), ((n_kv - 1) / ST) & 1);
  begin_turn();
  issue_pv(n_kv - 1);
  sx_wgmma_commit();
  if (c == 0) sx_bar_arrive(SX_WG_TURN + 1, SX_WG_CONSUMERS);  // warpgroup 1's last turn
  sx_wgmma_wait<0>();
  sx_pin(of);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(SX_FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(SX_FULL_MASK, l[r], 2);
  }
  T* oh = o + ((long long)b * Hq + h) * S * D;
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8) {
    const int col = 8 * n8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < S) {
        *reinterpret_cast<unsigned*>(oh + (long long)row * D + col) =
            SxPair<T>::pack(of[4 * n8 + 2 * r] / l[r], of[4 * n8 + 2 * r + 1] / l[r]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
using SxEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static SxEncodeTiled sx_encode_tiled() {
  static std::atomic<SxEncodeTiled> cached{nullptr};
  SxEncodeTiled fn = cached.load(std::memory_order_acquire);
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || p == nullptr) return nullptr;
    fn = reinterpret_cast<SxEncodeTiled>(p);
    cached.store(fn, std::memory_order_release);
  }
  return fn;
}

// heads matrices of rows x D elements, contiguous, as a 3-D tensor map
// (D, rows, heads) whose box is 64 columns by box_rows rows of one head,
// in the 128-byte swizzle; rows past the matrix read as zeros.
template <typename T>
static int sx_tensor_map(CUtensorMap* map, const T* base, int D, int rows, int heads, int box_rows) {
  const SxEncodeTiled encode = sx_encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T), (cuuint64_t)rows * D * sizeof(T)};
  const cuuint32_t box[3] = {SX_WG_PANEL, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 3, const_cast<T*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
static int sx_flash_wgmma_launch(const T* q, const T* k, const T* v, T* o, int B, int Hq, int Hkv,
                                 int S, int causal, float scale, void* stream) {
  CUtensorMap qm, km, vm;
  int e = sx_tensor_map(&qm, q, D, S, B * Hq, SX_WG_BQ);
  if (e == 0) e = sx_tensor_map(&km, k, D, S, B * Hkv, SX_WG_BK);
  if (e == 0) e = sx_tensor_map(&vm, v, D, S, B * Hkv, SX_WG_BK);
  if (e != 0) return e;
  constexpr int smem = SxWgTile<D>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      sx_flash_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sx_flash_wgmma_kernel<T, D><<<dim3((S + SX_WG_BQ - 1) / SX_WG_BQ, Hq, B), SX_WG_THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(qm, km, vm, o, Hq, Hkv, S,
                                                                     causal, scale * SX_LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int sx_flash_wgmma_dispatch(const T* q, const T* k, const T* v, T* o, int B, int Hq,
                                   int Hkv, int S, int D, int causal, float scale, void* stream) {
  switch (D) {
    case 64: return sx_flash_wgmma_launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, causal, scale, stream);
    case 128: return sx_flash_wgmma_launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sx_flash_wgmma_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                             const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                                             int Hq, int Hkv, int S, int D, int causal,
                                             float scale, void* stream) {
  return sx_flash_wgmma_dispatch(q, k, v, o, B, Hq, Hkv, S, D, causal, scale, stream);
}

extern "C" int sx_flash_wgmma_attention_f16(const __half* q, const __half* k, const __half* v,
                                            __half* o, int B, int Hq, int Hkv, int S, int D,
                                            int causal, float scale, void* stream) {
  return sx_flash_wgmma_dispatch(q, k, v, o, B, Hq, Hkv, S, D, causal, scale, stream);
}

// ------------------------------------------------------------ prefill, f32 on the CUDA cores
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

extern "C" int sx_flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                      int B, int Hq, int Hkv, int S, int D, int bq, int bk,
                                      int causal, float scale, void* stream) {
  switch (D) {
    case 8: return sx_flash_launch<float, 8>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    case 16: return sx_flash_launch<float, 16>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    case 32: return sx_flash_launch<float, 32>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    case 64: return sx_flash_launch<float, 64>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    case 128: return sx_flash_launch<float, 128>(q, k, v, o, B, Hq, Hkv, S, bq, bk, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
