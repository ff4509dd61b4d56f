// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_fa_kernel`): GQA
// softmax attention with the online softmax in fp32, causal / non-causal,
// sliding `window`, chunked-local `chunk` and `q_offset` masks, dead KV
// tiles skipped, rows with no live key written as 0.
//
// What bounds it on the H100.  At the serving prefill's shapes (B=8, S=256,
// H=14, KVH=2, D=64, bf16, causal) the call moves ~8.4 MB (q, k, v, out)
// and does ~0.94 GFLOP of live products: 2.5 us at 3.35 TB/s against
// 0.95 us at 989 TFLOP/s, so the bytes bound it.  This first version does
// its products with fp32 FMAs from shared memory, not on the tensor cores,
// and so runs far above that bound; `wgmma` and TMA are later work.
//
// Design.  One block of 128 threads per (batch*head, tile of 64 query
// rows); two threads share a row.  The block walks the KV tiles of 64 keys,
// stages each in shared memory as fp32 (K in rows padded to D+4 floats, so
// float4 reads are aligned and the two rows a warp reads fall in other
// banks), and keeps the running max, denominator and accumulator of its
// rows in registers.  A tile that the mask kills for every row of the
// block is skipped before it is loaded.  Masked scores are set to -1e30 and
// their probabilities to 0 explicitly: while a row has seen only masked
// keys its max is -1e30 and exp(s - m) would be 1.  Query head h reads KV
// head h / (H / KVH).  Arrays are read in the model's layout, q [B,Sq,H,D]
// and k/v [B,Skv,KVH,D], so the wrapper transposes nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per KV tile
constexpr int TPR = 2;                 // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int KPT = BK / TPR;          // scores per thread per tile
static_assert(TPR == 2, "the row reductions below pair lanes with xor 1");
static_assert(KPT <= 32, "the live-key mask of a thread is one 32-bit word");

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
  int B, Sq, Skv, H, KVH;
  int causal, window, chunk, q_offset;  // window/chunk <= 0: no such mask
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Params p) {
  static_assert(D % 8 == 0, "float4 reads of half a row need D % 8 == 0");
  constexpr int QS = D + 4;            // row stride of the q and k tiles
  constexpr int PS = BK + 1;           // row stride of the probability tile
  constexpr int DPT = D / TPR;         // output dims per thread

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [BQ][QS], pre-scaled
  float* k_s = q_s + BQ * QS;                     // [BK][QS]
  float* v_s = k_s + BK * QS;                     // [BK][D]
  float* p_s = v_s + BK * D;                      // [BQ][PS]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;
  const int q_row = q0 + r;
  const int q_pos = q_row + p.q_offset;
  const bool row_ok = q_row < p.Sq;    // the padding-row mask

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i % D;
    const int qr = q0 + rr;
    float x = 0.f;
    if (qr < p.Sq) {
      x = to_f32(q[(((size_t)b * p.Sq + qr) * p.H + h) * D + dd]) * p.scale;
    }
    q_s[rr * QS + dd] = x;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const int q_first = q0 + p.q_offset;
  const int q_last = q0 + BQ - 1 + p.q_offset;
  const int n_tiles = (p.Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_lo = kt * BK, k_hi = k_lo + BK - 1;
    // tile-level early-out, uniform over the block
    bool live = true;
    if (p.causal) live = live && k_lo <= q_last;
    if (p.window > 0) live = live && k_hi > q_first - p.window;
    if (p.chunk > 0) {
      live = live && (k_lo / p.chunk <= q_last / p.chunk) &&
             (k_hi / p.chunk >= q_first / p.chunk);
    }
    if (!live) continue;

    __syncthreads();  // the last tile's k_s / v_s are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int kk = i / D, dd = i % D;
      const int kp = k_lo + kk;
      float kx = 0.f, vx = 0.f;
      if (kp < p.Skv) {
        const size_t off = (((size_t)b * p.Skv + kp) * p.KVH + kvh) * D + dd;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[kk * QS + dd] = kx;
      v_s[kk * D + dd] = vx;
    }
    __syncthreads();

    // scores of this thread's keys: j * TPR + sub
    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&q_s[r * QS + d]);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&k_s[(j * TPR + sub) * QS + d]);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    unsigned live_bits = 0u;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kp = k_lo + j * TPR + sub;
      bool ok = row_ok && kp < p.Skv;
      if (p.causal) ok = ok && kp <= q_pos;
      if (p.window > 0) ok = ok && kp > q_pos - p.window;
      if (p.chunk > 0) ok = ok && (kp / p.chunk == q_pos / p.chunk);
      if (ok) live_bits |= 1u << j;
      s[j] = ok ? s[j] : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float pj = (live_bits >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      ls += pj;
      p_s[r * PS + j * TPR + sub] = pj;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();  // a row's probabilities come from its own two lanes

    const int d0 = sub * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float pk = p_s[r * PS + kk];
      const float* vr = &v_s[kk * D + d0];
#pragma unroll
      for (int i = 0; i < DPT; i += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + i);
        acc[i] = fmaf(pk, vv.x, acc[i]);
        acc[i + 1] = fmaf(pk, vv.y, acc[i + 1]);
        acc[i + 2] = fmaf(pk, vv.z, acc[i + 2]);
        acc[i + 3] = fmaf(pk, vv.w, acc[i + 3]);
      }
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + (((size_t)b * p.Sq + q_row) * p.H + h) * D + sub * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[i] = from_f32<T>(acc[i] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  fa_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* o, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, p, stream);
    case 32: return launch<T, 32>(q, k, v, o, p, stream);
    case 64: return launch<T, 64>(q, k, v, o, p, stream);
    case 128: return launch<T, 128>(q, k, v, o, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Sq,H,D], k/v [B,Skv,KVH,D], o [B,Sq,H,D], all contiguous and of one
// type (bf16 when is_bf16, else fp32).  window/chunk <= 0 turn those masks
// off.  Launches on `stream` and returns cudaGetLastError().
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Skv, int H, int KVH,
                          int D, int is_bf16, int causal, int window,
                          int chunk, int q_offset, float scale,
                          void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{B, Sq, Skv, H, KVH, causal, window, chunk, q_offset, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, o, p, st)
              : launch_d<float>(D, q, k, v, o, p, st);
  return (int)err;
}
