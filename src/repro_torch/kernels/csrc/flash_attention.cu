// Flash attention kernels for Hopper (sm_90a): causal prefill and
// one-token decode against a ring KV cache.
//
// Both are the CUDA counterparts of the Pallas TPU kernels of
// src/repro/kernels/flash_attention.py (flash_attention_fwd / _fwd_kernel
// and flash_decode_fwd / _decode_kernel). They compute the same function
// as the plain versions in kernels/ref.py (attention_ref, decode_ref):
//
//   * scores are dot(q, k) * scale in f32, then softcap * tanh(s / softcap)
//     when a softcap is given;
//   * masked scores are NEG_INF = -2^30 (not -inf), so the online-softmax
//     rescale alpha = exp(m_prev - m_new) stays finite; masked
//     probabilities are exactly 0;
//   * the final divide uses l > 0 ? l : 1, so a row with no valid key is
//     exactly 0;
//   * inputs are widened to f32 as they are staged, every sum is f32, and
//     the output is rounded once to q's dtype (f32, f16 or bf16);
//   * GQA: query head h reads KV head h / (H / KV); no repeat is made.
//
// What bounds them on this card. Prefill at the served shapes does about
// 4 * hd flops per (query, key) pair it keeps, far above the ~20 flops per
// byte at which an H100 stops being memory bound: it is bound by
// arithmetic. This first version runs it as f32 FMA on the CUDA cores (no
// tensor cores): a 64-query tile of Q stays in shared memory while 64-key
// tiles of K and V stream through it; each of 256 threads owns a 4 x 4
// block of the score tile and 4 rows x hd/16 columns of the output, so a
// shared-memory load feeds four FMAs. Decode reads the whole cache once
// per query head and does 4 * hd flops per slot: it is bound by the
// cache's bytes. One block per (batch, query head) streams the cache in
// tiles; wgmma, TMA and a split over the cache length are later work.
//
// Lengths need not divide the tiles: every tile load and every store
// bounds-checks its row, and rows or slots past the end are masked. Each
// tensor is addressed through element strides for its batch, head and
// sequence axes (the head dimension must be contiguous), so the model
// launches on its own [b, s, H, hd] activations and [b, C, KV, hd] cache
// with no transpose or copy.
//
// Every entry point is a plain C function that launches on the stream it
// is given and returns cudaGetLastError(), so a refused launch surfaces in
// the Python wrapper instead of being lost.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;   // -2^30
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Element strides of one [batch, head, seq, hd] operand (hd contiguous).
struct Strides {
  long long b, h, s;
};

// Scalar options shared by both kernels.
struct Opts {
  float scale;
  float softcap;   // <= 0: none
  int window;      // INT_MAX: none
};

__device__ __forceinline__ float score(float dot, const Opts& o) {
  float x = dot * o.scale;
  if (o.softcap > 0.f) x = o.softcap * tanhf(x / o.softcap);
  return x;
}

// ---------------------------------------------------------------------------
// flash_attention — replaces flash_attention_fwd (_fwd_kernel) of
// src/repro/kernels/flash_attention.py. Grid (q tiles, H, B); 256 threads
// as 16 (ty) x 16 (tx): thread (ty, tx) owns query rows ty*4 .. ty*4+3,
// score columns tx + 16 j (j < 4) and output columns tx + 16 c
// (c < HDP / 16). HDP is hd rounded up to the instantiated width; the
// padded columns are zero in Q and K, so they add nothing to a score, and
// are never stored. Query and key positions are the row and column
// indices. A key tile is skipped when it lies above the diagonal for every
// row of the query tile, or outside the window band for all of them.
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFwdThreads = 256;
constexpr int kQS = kBQ + 4;   // row stride of the transposed Q tile [HDP][kQS]
constexpr int kKS = kBK + 1;   // row stride of the transposed K tile [HDP][kKS]
constexpr int kPS = kBQ + 4;   // row stride of the transposed P tile [kBK][kPS]

template <int HDP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
         size_t(HDP * kQS + HDP * kKS + kBK * HDP + kBK * kPS);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group,
                 int SQ, int SK, int hd, Strides qs, Strides ks, Strides vs,
                 Strides os, Opts opt) {
  constexpr int CPT = HDP / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + HDP * kQS;
  float* v_s = k_s + HDP * kKS;
  float* p_s = v_s + kBK * HDP;

  // the last query tiles have the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / group;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qb = q + ib * qs.b + ih * qs.h;
  const T* kb = k + ib * ks.b + ikv * ks.h;
  const T* vb = v + ib * vs.b + ikv * vs.h;
  T* ob = o + ib * os.b + ih * os.h;

  for (int e = tid; e < kBQ * HDP; e += kFwdThreads) {
    const int r = e / HDP, d = e % HDP;
    float x = 0.f;
    if (q0 + r < SQ && d < hd) x = to_f(qb[(q0 + r) * qs.s + d]);
    q_s[d * kQS + r] = x;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // keys past the tile's last row lie above the diagonal for every row
  const int k_stop = min(SK, q0 + kBQ);
  for (int k0 = 0; k0 < k_stop; k0 += kBK) {
    if (q0 - (k0 + kBK - 1) >= opt.window) continue;   // outside the band
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * HDP; e += kFwdThreads) {
      const int t = e / HDP, d = e % HDP;
      float kx = 0.f, vx = 0.f;
      if (k0 + t < SK && d < hd) {
        kx = to_f(kb[(k0 + t) * ks.s + d]);
        vx = to_f(vb[(k0 + t) * vs.s + d]);
      }
      k_s[d * kKS + t] = kx;
      v_s[t * HDP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(&q_s[d * kQS + ty * 4]);
      float kd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kd[j] = k_s[d * kKS + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] = fmaf(qa.x, kd[j], s[0][j]);
        s[1][j] = fmaf(qa.y, kd[j], s[1][j]);
        s[2][j] = fmaf(qa.z, kd[j], s[2][j]);
        s[3][j] = fmaf(qa.w, kd[j], s[3][j]);
      }
    }

    // online softmax: the 16 threads of a row (one half-warp) agree on
    // its max and sum through shuffles; s[i][j] becomes the probability
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        s[i][j] = score(s[i][j], opt);
        ok[j] = c < SK && c <= r && r - c < opt.window;
        mx = fmaxf(mx, ok[j] ? s[i][j] : kNegInf);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&p_s[(tx + 16 * j) * kPS + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // the P tile is complete

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      const float4 pa =
          *reinterpret_cast<const float4*>(&p_s[t * kPS + ty * 4]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = v_s[t * HDP + tx + 16 * c];
        acc[0][c] = fmaf(pa.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pa.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pa.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pa.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= SQ) continue;
    const float div = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[r * os.s + d] = from_f<T>(acc[i][c] / div);
    }
  }
}

template <typename T, int HDP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int SQ, int SK, int hd, Strides qs, Strides ks,
               Strides vs, Strides os, Opts opt, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((SQ + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HDP><<<grid, kFwdThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H / KV, SQ, SK, hd, qs,
      ks, vs, os, opt);
  return int(cudaGetLastError());
}

template <typename T>
int fwd_for_width(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int KV, int SQ, int SK, int hd, Strides qs,
                  Strides ks, Strides vs, Strides os, Opts opt,
                  cudaStream_t s) {
  if (hd <= 32)
    return launch_fwd<T, 32>(q, k, v, o, B, H, KV, SQ, SK, hd, qs, ks, vs,
                             os, opt, s);
  if (hd <= 64)
    return launch_fwd<T, 64>(q, k, v, o, B, H, KV, SQ, SK, hd, qs, ks, vs,
                             os, opt, s);
  if (hd <= 128)
    return launch_fwd<T, 128>(q, k, v, o, B, H, KV, SQ, SK, hd, qs, ks, vs,
                              os, opt, s);
  if (hd <= 256)
    return launch_fwd<T, 256>(q, k, v, o, B, H, KV, SQ, SK, hd, qs, ks, vs,
                              os, opt, s);
  return int(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// flash_decode — replaces flash_decode_fwd (_decode_kernel) of
// src/repro/kernels/flash_attention.py. Grid (H, B); 128 threads. The
// block stages the query, then streams the cache in tiles of bk slots
// (K, V and slot positions into shared memory, widened to f32): thread t
// scores slot t of the tile, two block reductions give the tile's max and
// probability sum, and thread d accumulates output columns d and d + 128.
// A slot is valid iff 0 <= kpos <= qpos (and qpos - kpos < window); each
// slot is masked by its own position, so a wrapped ring, whose positions
// do not rise with the slot, needs nothing special. There is no tile skip.
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;

__host__ __device__ inline int dec_tile(int hd) {
  // about 64 KB of K and V tiles: 128 slots at hd 64, 64 at hd 128
  const int bk = 8192 / hd;
  return bk > kDecThreads ? kDecThreads : bk;
}

inline size_t dec_smem_bytes(int hd, int bk) {
  const int hd4 = (hd + 3) & ~3;
  return sizeof(float) * size_t(hd4 + bk * (hd + 1) + bk * hd + bk) +
         sizeof(int) * size_t(bk);
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, T* __restrict__ o,
                    int group, int C, int hd, int bk, Strides qs, Strides ks,
                    Strides vs, long long qp_b, long long kp_b,
                    long long kp_s, Strides os, Opts opt) {
  extern __shared__ float4 smem4[];
  __shared__ float red_max[kDecWarps], red_sum[kDecWarps];
  const int hd4 = (hd + 3) & ~3;
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + hd4;             // [bk][hd + 1]
  float* v_s = k_s + bk * (hd + 1);   // [bk][hd]
  float* p_s = v_s + bk * hd;         // [bk]
  int* kp_sh = reinterpret_cast<int*>(p_s + bk);

  const int ih = blockIdx.x, ib = blockIdx.y, ikv = ih / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + ib * qs.b + ih * qs.h;
  const T* kb = k + ib * ks.b + ikv * ks.h;
  const T* vb = v + ib * vs.b + ikv * vs.h;
  T* ob = o + ib * os.b + ih * os.h;
  const int* kpb = kpos + ib * kp_b;

  for (int d = tid; d < hd; d += kDecThreads) q_s[d] = to_f(qb[d]);
  const int qp = qpos[ib * qp_b];

  float m = kNegInf, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int k0 = 0; k0 < C; k0 += bk) {
    const int n = min(bk, C - k0);
    __syncthreads();   // the previous tile is consumed (and q_s is staged)
    for (int e = tid; e < n * hd; e += kDecThreads) {
      const int t = e / hd, d = e - t * hd;
      k_s[t * (hd + 1) + d] = to_f(kb[(k0 + t) * ks.s + d]);
      v_s[t * hd + d] = to_f(vb[(k0 + t) * vs.s + d]);
    }
    for (int t = tid; t < n; t += kDecThreads) kp_sh[t] = kpb[(k0 + t) * kp_s];
    __syncthreads();

    float x = kNegInf;
    bool ok = false;
    if (tid < n) {
      const float* kr = k_s + tid * (hd + 1);
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(q_s[d], kr[d], dot);
      x = score(dot, opt);
      const int kp = kp_sh[tid];
      ok = kp >= 0 && kp <= qp && qp - kp < opt.window;
    }
    float mx = ok ? x : kNegInf;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();
    mx = red_max[0];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) mx = fmaxf(mx, red_max[w]);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(x - m_new) : 0.f;
    if (tid < n) p_s[tid] = p;
    float ps = p;
#pragma unroll
    for (int off = 16; off; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
    if (lane == 0) red_sum[warp] = ps;
    __syncthreads();   // p_s and red_sum are complete
    ps = red_sum[0];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) ps += red_sum[w];
    l = l * alpha + ps;
    m = m_new;
    acc0 *= alpha;
    acc1 *= alpha;
    if (tid < hd)
      for (int t = 0; t < n; ++t) acc0 = fmaf(p_s[t], v_s[t * hd + tid], acc0);
    if (tid + kDecThreads < hd)
      for (int t = 0; t < n; ++t)
        acc1 = fmaf(p_s[t], v_s[t * hd + tid + kDecThreads], acc1);
  }
  const float div = l > 0.f ? l : 1.f;
  if (tid < hd) ob[tid] = from_f<T>(acc0 / div);
  if (tid + kDecThreads < hd) ob[tid + kDecThreads] = from_f<T>(acc1 / div);
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* qpos, const void* kpos, void* o, int B, int H,
                  int KV, int C, int hd, Strides qs, Strides ks, Strides vs,
                  long long qp_b, long long kp_b, long long kp_s, Strides os,
                  Opts opt, cudaStream_t stream) {
  if (hd > 2 * kDecThreads) return int(cudaErrorInvalidValue);
  const int bk = dec_tile(hd);
  const size_t smem = dec_smem_bytes(hd, bk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  flash_decode_kernel<T><<<dim3(H, B), kDecThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qpos,
      (const int*)kpos, (T*)o, H / KV, C, hd, bk, qs, ks, vs, qp_b, kp_b,
      kp_s, os, opt);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, H, SQ, hd], k and v [B, KV, SK, hd], o like q, each through its
// (batch, head, seq) element strides; dtype 0 f32, 1 f16, 2 bf16;
// window INT_MAX for none, softcap 0 for none.
int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int SQ, int SK, int hd,
                       long long q_b, long long q_h, long long q_s,
                       long long k_b, long long k_h, long long k_s,
                       long long v_b, long long v_h, long long v_s,
                       long long o_b, long long o_h, long long o_s,
                       float scale, int window, float softcap, int dtype,
                       void* stream) {
  const Strides qs{q_b, q_h, q_s}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, o_s};
  const Opts opt{scale, softcap, window};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return fwd_for_width<float>(q, k, v, o, B, H, KV, SQ, SK, hd, qs, ks,
                                  vs, os, opt, s);
    case kF16:
      return fwd_for_width<__half>(q, k, v, o, B, H, KV, SQ, SK, hd, qs, ks,
                                   vs, os, opt, s);
    case kBF16:
      return fwd_for_width<__nv_bfloat16>(q, k, v, o, B, H, KV, SQ, SK, hd,
                                          qs, ks, vs, os, opt, s);
  }
  return int(cudaErrorInvalidValue);
}

// q [B, H, 1, hd], k and v [B, KV, C, hd] and o like q through their
// strides; qpos [B, 1] and kpos [B, C] int32 through theirs.
int rt_flash_decode(const void* q, const void* k, const void* v,
                    const void* qpos, const void* kpos, void* o, int B, int H,
                    int KV, int C, int hd, long long q_b, long long q_h,
                    long long k_b, long long k_h, long long k_s,
                    long long v_b, long long v_h, long long v_s,
                    long long qp_b, long long kp_b, long long kp_s,
                    long long o_b, long long o_h, float scale, int window,
                    float softcap, int dtype, void* stream) {
  const Strides qs{q_b, q_h, 0}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, 0};
  const Opts opt{scale, softcap, window};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch_decode<float>(q, k, v, qpos, kpos, o, B, H, KV, C, hd, qs,
                                  ks, vs, qp_b, kp_b, kp_s, os, opt, s);
    case kF16:
      return launch_decode<__half>(q, k, v, qpos, kpos, o, B, H, KV, C, hd,
                                   qs, ks, vs, qp_b, kp_b, kp_s, os, opt, s);
    case kBF16:
      return launch_decode<__nv_bfloat16>(q, k, v, qpos, kpos, o, B, H, KV,
                                          C, hd, qs, ks, vs, qp_b, kp_b, kp_s,
                                          os, opt, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
