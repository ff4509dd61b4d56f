// Decode attention (one query token per row against a KV cache) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/kernel.py, body `_decode_kernel`):
// per-row `valid` length and position `pos`, sliding `window` and
// chunked-local `chunk` masks unless the cache is `rolling`, softmax in
// fp32, rows with no live key written as 0.
//
// What bounds it on the H100.  The work is one pass over the live part of
// the cache: each K and V element is read once and used for G multiply-adds
// (G = H / KVH query heads share a KV head).  At qwen2-0.5b's decode shapes
// (B=8, KVH=2, G=7, D=64, bf16, ~300 live slots) that is ~1.2 MB, 0.4 us at
// 3.35 TB/s, and the FLOPs are negligible: the bytes bound it, and at this
// size the launch itself costs more than either.
//
// Design.  One block of 8 warps per (batch row, KV head) serves the whole
// query group (G <= 8, no padding needed).  The loop runs over the live
// slots only, [lo, hi) from `valid`, `pos`, `window` and `chunk`, never to
// S_max, so no per-slot mask is needed inside it.  Warp w takes slots
// lo + w, lo + w + 8, ...; a lane holds D/32 dims of the query group, the
// slot's K and V row and its share of the accumulators, and a score is a
// dot product reduced across the warp with shuffles.  Each warp keeps its
// own running max, denominator and accumulator; the eight partial softmaxes
// are then merged in shared memory with the log-sum-exp correction
// exp(m_w - max_w m_w), the `combine_partials` arithmetic of the JAX
// package's decode_attention/ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 8;                // largest query group served

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Params {
  int S, KVH, G;
  int window, chunk, rolling;          // window/chunk <= 0: no such mask
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                  const T* __restrict__ cv, const int* __restrict__ valid,
                  const int* __restrict__ pos, T* __restrict__ o, Params p) {
  constexpr int NI = (D + 31) / 32;    // dims per lane
  __shared__ float sm_m[WARPS][MAXG];
  __shared__ float sm_l[WARPS][MAXG];
  __shared__ float sm_acc[WARPS][MAXG][D];

  const int b = blockIdx.x / p.KVH, kvh = blockIdx.x % p.KVH;
  const int H = p.KVH * p.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float qr[MAXG][NI];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < p.G && d < D)
                     ? to_f32(q[((size_t)b * H + kvh * p.G + g) * D + d]) *
                           p.scale
                     : 0.f;
    }
  }

  // live slots: k_pos < valid, and unless rolling k_pos > pos - window and
  // k_pos / chunk == pos / chunk
  const int vb = valid[b], pb = pos[b];
  int lo = 0, hi = min(vb, p.S);
  if (!p.rolling) {
    if (p.window > 0) lo = max(lo, pb - p.window + 1);
    if (p.chunk > 0) {
      lo = max(lo, (pb / p.chunk) * p.chunk);
      hi = min(hi, (pb / p.chunk + 1) * p.chunk);
    }
  }

  float m[MAXG], l[MAXG], acc[MAXG][NI];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[g][i] = 0.f;
  }

  for (int kp = lo + warp; kp < hi; kp += WARPS) {
    const size_t off = (((size_t)b * p.S + kp) * p.KVH + kvh) * D;
    float kr[NI], vr[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < D ? to_f32(ck[off + d]) : 0.f;
      vr[i] = d < D ? to_f32(cv[off + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < p.G) {                   // uniform over the warp
        float sd = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) sd = fmaf(qr[g][i], kr[i], sd);
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) {
          sd += __shfl_xor_sync(0xffffffffu, sd, w);
        }
        const float m_new = fmaxf(m[g], sd);
        const float alpha = expf(m[g] - m_new);
        const float pk = expf(sd - m_new);
        l[g] = l[g] * alpha + pk;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[g][i] = fmaf(acc[g][i], alpha, pk * vr[i]);
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) sm_acc[warp][g][d] = acc[g][i];
    }
  }
  __syncthreads();

  // log-sum-exp merge of the warps' partial softmaxes
  for (int idx = threadIdx.x; idx < p.G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float mg = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mg = fmaxf(mg, sm_m[w][g]);
    float lg = 0.f, ag = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][g] - mg);
      lg = fmaf(sm_l[w][g], c, lg);
      ag = fmaf(sm_acc[w][g][d], c, ag);
    }
    o[((size_t)b * H + kvh * p.G + g) * D + d] =
        from_f32<T>(ag / fmaxf(lg, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* ck, const void* cv,
                   const int* valid, const int* pos, void* o, int B,
                   const Params& p, cudaStream_t stream) {
  decode_kernel<T, D><<<B * p.KVH, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), valid, pos, static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* ck, const void* cv,
                     const int* valid, const int* pos, void* o, int B,
                     const Params& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, ck, cv, valid, pos, o, B, p, stream);
    case 32: return launch<T, 32>(q, ck, cv, valid, pos, o, B, p, stream);
    case 64: return launch<T, 64>(q, ck, cv, valid, pos, o, B, p, stream);
    case 128: return launch<T, 128>(q, ck, cv, valid, pos, o, B, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D], cache_k/v [B,S,KVH,D], o [B,H,D], one type (bf16 when is_bf16,
// else fp32), all contiguous; valid/pos [B] int32 on the device.  H = KVH*G
// with G <= 8.  window/chunk <= 0 turn those masks off.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int decode_forward(const void* q, const void* cache_k,
                              const void* cache_v, const void* valid,
                              const void* pos, void* o, int B, int S,
                              int KVH, int G, int D, int is_bf16, int window,
                              int chunk, int rolling, float scale,
                              void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || G <= 0 || G > MAXG) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{S, KVH, G, window, chunk, rolling, scale};
  const int* vp = static_cast<const int*>(valid);
  const int* pp = static_cast<const int*>(pos);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(D, q, cache_k, cache_v, vp, pp, o, B,
                                        p, st)
              : launch_d<float>(D, q, cache_k, cache_v, vp, pp, o, B, p, st);
  return (int)err;
}
