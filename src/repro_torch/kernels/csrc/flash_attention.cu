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
//   * every sum is f32, and the output is rounded once to q's dtype (f32,
//     f16 or bf16);
//   * GQA: query head h reads KV head h / (H / KV); no repeat is made.
//
// Prefill has two routes, chosen by the wrapper from dtype and head_dim:
//
//   * tensor cores (flash_fwd_tc_kernel): bf16 / f16 at head_dim 64 or
//     128. Prefill does about 4 * hd flops per (query, key) pair it keeps,
//     far above the ~295 flops per byte at which an H100 stops being
//     memory bound in bf16: it is bound by operations, and only wgmma
//     reaches the tensor cores' rate. Both products run on wgmma with f32
//     accumulators; see the kernel's note for the tiles and the precision.
//   * CUDA cores (flash_fwd_kernel): f32, and every other head_dim, as f32
//     FMA (a 64-query tile of Q stays in shared memory while 64-key tiles
//     of K and V stream through it).
//
// Decode does about 4 * G flops per cached element it reads (G query
// heads share one KV head): it is bound by the cache's bytes, so it runs
// on the CUDA cores and is split over the cache instead, to put enough
// blocks in flight and to read each KV head once (flash_decode_kernel).
//
// Lengths need not divide the tiles: rows or slots past the end are
// zero-filled as they are staged and masked. Each tensor is addressed
// through element strides for its batch, head and sequence axes (the head
// dimension must be contiguous), so the model launches on its own
// [b, s, H, hd] activations and [b, C, KV, hd] cache with no transpose or
// copy.
//
// Every entry point is a plain C function that launches on the stream it
// is given and returns cudaGetLastError(), so a refused launch surfaces in
// the Python wrapper instead of being lost.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1073741824.0f;   // -2^30
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

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

// Scalar options shared by the kernels.
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

// A kernel's dynamic shared-memory limit is set once per device (again
// only if a launch needs more than was set), not before every launch: a
// runtime API call per launch costs a host-bound decode step. ``reserved`` is
// the caller's per-instantiation record, indexed by device.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, int* reserved) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (int(bytes) <= reserved[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) reserved[dev] = int(bytes);
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes < 16 zero-fills
// the rest (0: nothing is read, the 16 bytes are zeros).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// flash_attention, CUDA-core route (f32, and head dims other than 64 / 128)
// — replaces flash_attention_fwd (_fwd_kernel) of
// src/repro/kernels/flash_attention.py. Grid (q tiles, H, B); 256 threads
// as 16 (ty) x 16 (tx): thread (ty, tx) owns query rows ty*4 .. ty*4+3,
// score columns tx + 16 j (j < 4) and output columns tx + 16 c
// (c < HDP / 16); each shared-memory load feeds four FMAs. Inputs are
// widened to f32 as they are staged. HDP is hd rounded up to the
// instantiated width; the padded columns are zero in Q and K, so they add
// nothing to a score, and are never stored. Query and key positions are
// the row and column indices. A key tile is skipped when it lies above the
// diagonal for every row of the query tile, or outside the window band for
// all of them.
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
  static int reserved[kMaxDevices];
  const size_t smem = fwd_smem_bytes<HDP>();
  const cudaError_t err =
      reserve_smem(flash_fwd_kernel<T, HDP>, smem, reserved);
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
// flash_attention, tensor-core route (bf16 / f16 at head_dim 64 or 128) —
// replaces flash_attention_fwd (_fwd_kernel) of
// src/repro/kernels/flash_attention.py. Bound by operations in these
// dtypes, so both products run on wgmma (f32 accumulators):
//
//   * Grid (q tiles of 128 rows, H, B), 256 threads: two warpgroups, each
//     owning 64 query rows; two blocks an SM at head_dim 64. Q stays in
//     shared memory; K and V tiles of 64 keys stream through a three-stage
//     ring filled with 16-byte cp.async (issued by all threads, the next
//     two tiles in flight while one is computed, one barrier a tile). Rows
//     past the end are zero-filled by the copy (source size 0), so no
//     padding is needed.
//   * Every tile is stored as 128-byte rows (64 columns) in the 128-byte
//     swizzle wgmma descriptors name: 16-byte chunk c of row r lands at
//     chunk c ^ (r % 8); head_dim 128 is two such column blocks.
//   * S = Q K^T: wgmma m64n64k16 with both operands in shared memory, K
//     K-major (hd contiguous). Scale, softcap, masks and the online
//     softmax then run in f32 on the accumulator fragment, in base 2 (row
//     max and sum by quad shuffles; masks only on tiles that cross a
//     row's band edge).
//   * O += P V: wgmma m64n{hd}k16 with P from registers — the f32 S
//     fragment, converted to 16 bits, is already in the A-operand register
//     layout — and V from shared memory, MN-major (the descriptor's
//     transpose bit).
//   * Precision: P is split into hi = round(P) and lo = round(P - hi) in
//     the input dtype and both are multiplied into the same accumulator
//     (1.5x the tensor-core work of one P), which keeps P to about 2^-16,
//     as near the plain version's f32 P as its one-ulp bar needs.
//   * A warpgroup skips a tile that lies above the diagonal or outside
//     the window band for all its 64 rows.
// ---------------------------------------------------------------------------
constexpr int kTcBQ = 128;       // query rows a block (two warpgroups)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcBK = 64;        // keys a tile
constexpr int kTcThreads = 256;

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers an asynchronous wgmma writes are read only after its wait:
// this tells the compiler they change here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units) and layout
// type 1 (128-byte swizzle) in bits 62-63. Tiles are 1024-byte aligned, so
// the base offset is 0.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// wgmma with f32 accumulators d. SS: A and B from shared memory (both
// K-major); scale_d = 0 overwrites d. RS: A from registers (four 32-bit
// registers of two 16-bit values), B from shared memory MN-major (the
// transpose bit), accumulating into d.
#define RT_WGMMA_SS_N64(TY)                                                             \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),         \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),       \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),   \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31])                                                        \
      : "l"(da), "l"(db), "r"(scale_d))

#define RT_WGMMA_RS_N64(TY)                                                             \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),         \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),       \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),   \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31])                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define RT_WGMMA_RS_N128(TY)                                                              \
  asm volatile(                                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                       \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"    \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),     \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),     \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),     \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),     \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),     \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    RT_WGMMA_SS_N64("f16");
  } else {
    RT_WGMMA_SS_N64("bf16");
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) {
    if constexpr (std::is_same<T, __half>::value) {
      RT_WGMMA_RS_N64("f16");
    } else {
      RT_WGMMA_RS_N64("bf16");
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      RT_WGMMA_RS_N128("f16");
    } else {
      RT_WGMMA_RS_N128("bf16");
    }
  }
}

// Two floats as one 32-bit register of two 16-bit values (a in the low
// half), each rounded to nearest.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) as hi = their 16-bit roundings and lo = the roundings of what
// hi leaves, both packed as pack2 packs them.
template <typename T>
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<T>(a, b);
  const T* h = reinterpret_cast<const T*>(&hi);
  lo = pack2<T>(a - to_f(h[0]), b - to_f(h[1]));
}

// Rows [row0, row0 + ROWS) of a [*, HD] operand (row stride `stride`
// elements) into a 128-byte-swizzled tile at shared address `dst`: column
// block cb of row r at cb * ROWS * 128 + r * 128, its 16-byte chunk c at
// chunk c ^ (r % 8). Rows at or past `limit` are zero-filled.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          long long stride, int row0,
                                          int limit, int tid) {
  constexpr int CPR = HD / 8;   // 16-byte chunks a row
  static_assert(ROWS * CPR % kTcThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / kTcThreads; ++i) {
    const int e = tid + i * kTcThreads;
    const int r = e / CPR, cc = e % CPR;
    const bool ok = row0 + r < limit;
    const T* s = src + (ok ? row0 + r : 0) * stride + cc * 8;
    cp_async16(dst + (cc >> 3) * (ROWS * 128) + r * 128 +
                   (((cc & 7) ^ (r & 7)) << 4),
               s, ok ? 16 : 0);
  }
}

constexpr int kTcStages = 3;   // ring stages of K and V tiles

template <typename T, int HD>
constexpr size_t tc_smem_bytes() {
  // 1024 bytes of slack to align the tiles, Q, then the stages of K and V
  return 1024 + size_t(HD / 64) * 128 * (kTcBQ + 2 * kTcStages * kTcBK);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; -inf gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax on a warpgroup's S fragment (s[4 j + 2 h + e]
// is row r0 + 8 h, key k0 + 8 j + 2 quad + e), in f32 and base 2: a score
// x is kept as x * log2(e), so exp(x - m) is one exp2. A masked score
// becomes -inf, which adds nothing to the max and gives exactly 0; tiles
// wholly inside every row's band skip the masks. Rescales acc by
// exp(m_old - m_new) and leaves P as A fragments of hi and lo halves.
template <typename T, int NS, int NO>
__device__ __forceinline__ void tc_softmax(
    float (&s)[NS], float (&acc)[NO], float (&m)[2], float (&l)[2],
    uint32_t (&ph)[NS / 8][4], uint32_t (&pl)[NS / 8][4], int k0, int r0,
    int wg_row0, int quad, int SK, const Opts& opt) {
  const float scale2 = opt.scale * kLog2e;
  const bool inside = k0 + kTcBK - 1 <= wg_row0 && k0 + kTcBK <= SK &&
                      wg_row0 + 63 - k0 < opt.window;
  if (inside) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      s[i] = opt.softcap > 0.f ? score(s[i], opt) * kLog2e : s[i] * scale2;
  } else {
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + 2 * quad + e, r = r0 + 8 * h;
          float& x = s[4 * j + 2 * h + e];
          // 0 <= r - c < window, as one unsigned compare
          const bool ok = c < SK && unsigned(r - c) < unsigned(opt.window);
          x = !ok ? -INFINITY
                  : opt.softcap > 0.f ? score(x, opt) * kLog2e : x * scale2;
        }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    ps[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ps[h] += __shfl_xor_sync(kFull, ps[h], 1);
    ps[h] += __shfl_xor_sync(kFull, ps[h], 2);
    l[h] = l[h] * alpha[h] + ps[h];
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
  // k16 step kk of P V takes s[8 kk .. 8 kk + 7] in order
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r],
                pl[kk][r]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kTcThreads, HD == 64 ? 2 : 1)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int group,
                    int SQ, int SK, Strides qs, Strides ks, Strides vs,
                    Strides os, Opts opt) {
  constexpr int Q_BYTES = (HD / 64) * kTcBQ * 128;
  constexpr int KV_BYTES = (HD / 64) * kTcBK * 128;   // one K or V tile
  constexpr int KSTEPS = HD / 16;                      // k16 steps of Q K^T
  constexpr int PSTEPS = kTcBK / 16;                   // k16 steps of P V
  constexpr int NS = kTcBK / 2;                        // S floats a thread
  constexpr int NO = HD / 2;                           // O floats a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_sm = base;
  // stage s: K at kv_sm + 2 s KV_BYTES, V right after it
  const uint32_t kv_sm = base + Q_BYTES;

  // the last query tiles have the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / group;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, quad = lane & 3;

  const T* qb = q + ib * qs.b + ih * qs.h;
  const T* kb = k + ib * ks.b + ikv * ks.h;
  const T* vb = v + ib * vs.b + ikv * vs.h;
  T* ob = o + ib * os.b + ih * os.h;

  // key tiles [t_begin, t_end): the first holds the band's first key of
  // the block's first row, the last the block's last row
  const int t_begin = max(0, q0 - opt.window + 1) / kTcBK;
  const int t_end = (min(SK, q0 + kTcBQ) + kTcBK - 1) / kTcBK;
  auto load_kv = [&](int t) {   // K and V of key tile t into its stage
    const uint32_t dst = kv_sm + 2 * ((t - t_begin) % kTcStages) * KV_BYTES;
    load_tile<T, HD, kTcBK>(dst, kb, ks.s, t * kTcBK, SK, tid);
    load_tile<T, HD, kTcBK>(dst + KV_BYTES, vb, vs.s, t * kTcBK, SK, tid);
  };

  // this thread's accumulator rows: r0 and r0 + 8 of the warpgroup's 64;
  // a warpgroup skips a tile above the diagonal or outside the band for
  // all its rows
  const int wg_row0 = q0 + wg * 64;
  const int r0 = wg_row0 + warp * 16 + (lane >> 2);
  const bool wg_live = wg_row0 < SQ;
  auto live = [&](int t) {
    const int k0 = t * kTcBK;
    return wg_live && k0 <= wg_row0 + 63 &&
           wg_row0 - (k0 + kTcBK - 1) < opt.window;
  };
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // three stages: tile t is computed while tiles t + 1 and t + 2 load
  load_tile<T, HD, kTcBQ>(q_sm, qb, qs.s, q0, SQ, tid);
  if (t_begin < t_end) load_kv(t_begin);
  cp_async_commit();
  if (t_begin + 1 < t_end) load_kv(t_begin + 1);
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<1>();    // all but tile t + 1 have landed (tile t, Q)
    fence_proxy_async();   // ... and are visible to wgmma's operand reads
    __syncthreads();       // ... for every thread; tile t - 1 is consumed
    if (t + 2 < t_end) load_kv(t + 2);
    cp_async_commit();
    if (!live(t)) continue;
    const uint32_t k_sm = kv_sm + 2 * ((t - t_begin) % kTcStages) * KV_BYTES;
    const uint32_t v_sm = k_sm + KV_BYTES;

    // S = Q K^T
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t col = kk >> 2, off = (kk & 3) * 32;
      wgmma_ss_n64<T>(
          s,
          gmma_desc(q_sm + col * (kTcBQ * 128) + wg * (64 * 128) + off, 16,
                    1024),
          gmma_desc(k_sm + col * (kTcBK * 128) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    uint32_t ph[PSTEPS][4], pl[PSTEPS][4];
    tc_softmax<T>(s, acc, m, l, ph, pl, t * kTcBK, r0, wg_row0, quad, SK,
                  opt);

    // O += P V, P as hi then lo
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
      // keys 16 kk .. 16 kk + 15: two 8-row groups of 1024 bytes
      const uint64_t dv = gmma_desc(v_sm + kk * 2048, kTcBK * 128, 1024);
      wgmma_rs<T, HD>(acc, ph[kk], dv);
      wgmma_rs<T, HD>(acc, pl[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    // the A registers too are read asynchronously: keep them until here
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+r"(ph[kk][r]), "+r"(pl[kk][r])::"memory");
  }
  cp_async_wait<0>();   // no copy outlives the block (no tile at all)

  if (!wg_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= SQ) continue;
    const float div = l[h] > 0.f ? l[h] : 1.f;
    T* orow = ob + r * os.s + 2 * quad;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack2<T>(acc[4 * j + 2 * h] / div, acc[4 * j + 2 * h + 1] / div);
  }
}

template <typename T, int HD>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int KV, int SQ, int SK, Strides qs,
                  Strides ks, Strides vs, Strides os, Opts opt,
                  cudaStream_t stream) {
  static int reserved[kMaxDevices];
  const size_t smem = tc_smem_bytes<T, HD>();
  const cudaError_t err =
      reserve_smem(flash_fwd_tc_kernel<T, HD>, smem, reserved);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((SQ + kTcBQ - 1) / kTcBQ, H, B);
  flash_fwd_tc_kernel<T, HD><<<grid, kTcThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H / KV, SQ, SK, qs, ks,
      vs, os, opt);
  return int(cudaGetLastError());
}

template <typename T>
int fwd_tc_for_width(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int SQ, int SK, int hd,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     Opts opt, cudaStream_t s) {
  if (hd == 64)
    return launch_fwd_tc<T, 64>(q, k, v, o, B, H, KV, SQ, SK, qs, ks, vs, os,
                                opt, s);
  if (hd == 128)
    return launch_fwd_tc<T, 128>(q, k, v, o, B, H, KV, SQ, SK, qs, ks, vs,
                                 os, opt, s);
  return int(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// flash_decode — replaces flash_decode_fwd (_decode_kernel) of
// src/repro/kernels/flash_attention.py. Bound by the cache's bytes, so it
// runs on the CUDA cores in f32 and aims at bytes in flight and bytes
// read once:
//
//   * Grid (splits, KV, B), 128 threads, or 512 (four a slot, as the
//     wrapper picks: long dots on a grid smaller than the card). A block
//     owns one KV head of one row and one contiguous range of `per` slots,
//     and scores all
//     G = H / KV query heads of that KV head against each slot it loads:
//     K and V are read once per KV head, not G times. The wrapper picks
//     the tile (128 slots, fewer for wide rows) and the splits, enough
//     blocks to fill the card where the cache allows.
//   * K, V and slot positions stream through a ring of up to four tiles
//     copied with cp.async (16 bytes a copy for K and V when every row
//     starts 16-byte aligned, else element copies), the next tiles in
//     flight while one is computed. Rows are padded by 16 bytes in shared
//     memory, so threads reading neighbouring rows hit other banks.
//   * Thread t (or the four threads 4t .. 4t + 3, each over every fourth
//     16-byte chunk, summed by shuffles) scores slot t of the tile against
//     every head (K's chunk converted once for up to eight heads); the
//     block agrees on each head's tile max through shared memory and runs
//     the online softmax (m, l) in f32. Then thread (column pair, sub)
//     adds P V over every nsub-th slot for up to eight heads at once, into
//     its own partial accumulator; the nsub partials are summed in order
//     at the end.
//   * The block writes its partials (m, l, acc) per query head to f32
//     scratch. The last block of each (row, KV head) to finish — found by
//     an int counter, __threadfence and atomicAdd — merges all splits in
//     split order (deterministic, no float atomics): weights
//     exp(m_s - max m) for every (split, head) in parallel, then every
//     thread sums four output columns over the splits with 16-byte loads.
//     It writes the output and sets the counter back to 0 for the next
//     launch.
//   * A slot is valid iff 0 <= kpos <= qpos (and qpos - kpos < window);
//     each slot is masked by its own position, so a wrapped ring needs
//     nothing special. A split with no valid slot leaves m = NEG_INF,
//     l = 0, acc = 0 and adds exactly nothing; a row with none anywhere is
//     exactly 0.
// ---------------------------------------------------------------------------
constexpr int kDecSlots = 128;    // slots a tile at most; a block has
                                  // kDecSlots * TPS threads
constexpr int kDecStages = 4;     // tiles in the ring at most (2 at least)
constexpr int kDecRingBytes = 144 * 1024;   // ring budget beyond 2 stages

// Stages of the decode ring: as many tiles as fit kDecRingBytes, 2 to 4.
inline int dec_stages(int tile_bytes) {
  const int n = kDecRingBytes / (2 * tile_bytes);
  return n < 2 ? 2 : n > kDecStages ? kDecStages : n;
}

// Shared memory of one decode block, in bytes: q [G][hdp], acc
// [nsub][G][hd], s [G][ts], red and sum [G][warps], m [2][G], l [G]
// (f32); positions [stages][ts] and the merge flag (int); 16 bytes of
// alignment slack; then the ring (`alloc` of its stages, a K and a V tile
// of ts rows of row_bytes each), whose space the merge reuses for
// 2 (splits + 1) G floats.
inline size_t dec_smem_bytes(int G, int hd, int hdp, int nsub, int warps,
                             int ts, int row_bytes, int alloc, int splits) {
  const size_t ring = size_t(2) * alloc * ts * row_bytes;
  const size_t merge = sizeof(float) * 2 * size_t(splits + 1) * G;
  return sizeof(float) * size_t(G) *
             (hdp + size_t(nsub) * hd + ts + 2 * warps + 3) +
         sizeof(int) * (size_t(kDecStages) * ts + 1) + 16 +
         (ring > merge ? ring : merge);
}

// One 16-byte chunk of shared memory as 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void chunk_to_f(const unsigned char* p, float* x);
template <>
__device__ __forceinline__ void chunk_to_f<float>(const unsigned char* p,
                                                  float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
template <>
__device__ __forceinline__ void chunk_to_f<__nv_bfloat16>(
    const unsigned char* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void chunk_to_f<__half>(const unsigned char* p,
                                                   float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Two neighbouring elements of shared memory (one aligned load) as floats.
template <typename T>
__device__ __forceinline__ float2 pair_to_f(const unsigned char* p);
template <>
__device__ __forceinline__ float2 pair_to_f<float>(const unsigned char* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 pair_to_f<__nv_bfloat16>(
    const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 pair_to_f<__half>(const unsigned char* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// NH: heads a pass scores or adds P V into (1, 2, 4, 6 or 8; G is covered
// in passes, the last one's missing heads clamped to head G - 1, unused).
template <typename T, int NH, int TPS>
__global__ void __launch_bounds__(kDecSlots * TPS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, T* __restrict__ o,
                    float* __restrict__ part, int* __restrict__ counters,
                    int group, int C, int hd, int per, int ts, int vec,
                    int stages, Strides qs, Strides ks, Strides vs,
                    long long qp_b, long long kp_b, long long kp_s,
                    Strides os, Opts opt) {
  constexpr int EPC = 16 / sizeof(T);   // elements a 16-byte chunk
  constexpr int NT = kDecSlots * TPS, NW = NT / 32;   // threads, warps
  const int G = group, nch = (hd + EPC - 1) / EPC, hdp = nch * EPC;
  const int row_bytes = (nch + 1) * 16, tile_bytes = ts * row_bytes;
  const int ncp = (hd + 1) / 2, nsub = NT / ncp;
  const int split = blockIdx.x, splits = gridDim.x;
  const int ikv = blockIdx.y, KV = gridDim.y, ib = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);   // [G][hdp]
  float* acc_sh = q_sh + G * hdp;                  // [nsub][G][hd]
  float* s_sh = acc_sh + nsub * G * hd;            // [G][ts] scores, then p
  float* red_sh = s_sh + G * ts;                   // [G][warps] tile maxima
  float* sum_sh = red_sh + G * NW;                 // [G][warps] sums of p
  float* m_sh = sum_sh + G * NW;                   // [2][G] by tile parity
  float* l_sh = m_sh + 2 * G;                      // [G]
  int* pos_sh = reinterpret_cast<int*>(l_sh + G);  // [stage][ts]
  int* last_sh = pos_sh + kDecStages * ts;
  // stage st: K tile at 2 st tile_bytes, V tile right after it
  unsigned char* kv_sh = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(last_sh + 1) + 15) & ~uintptr_t(15));

  const int h0 = ikv * G;
  const int s_begin = split * per, s_end = min(C, s_begin + per);
  const int ntiles = s_end > s_begin ? (s_end - s_begin + ts - 1) / ts : 0;
  const T* kb = k + ib * ks.b + ikv * ks.h;
  const T* vb = v + ib * vs.b + ikv * vs.h;
  const int* kpb = kpos + ib * kp_b;

  // K and V rows and slot positions of tile `tile` into its stage
  auto stage = [&](int tile) {
    const int t0 = s_begin + tile * ts;
    const int n = min(ts, s_end - t0), st = tile % stages;
    unsigned char* kd = kv_sh + 2 * st * tile_bytes;
    unsigned char* vd = kd + tile_bytes;
    if (vec) {
      // thread (row r0, chunk c) copies chunk c of rows r0, r0 + rows, ...
      const int rows = NT / nch, r0 = tid / nch, c = tid - r0 * nch;
      if (r0 < rows) {
        const int bytes = min(16, (hd - c * EPC) * int(sizeof(T)));
        const uint32_t kd_s = smem_addr(kd + r0 * row_bytes + c * 16);
        const uint32_t vd_s = smem_addr(vd + r0 * row_bytes + c * 16);
        const T* ksrc = kb + (t0 + r0) * ks.s + c * EPC;
        const T* vsrc = vb + (t0 + r0) * vs.s + c * EPC;
        for (int r = r0, i = 0; r < n; r += rows, ++i) {
          cp_async16(kd_s + i * rows * row_bytes, ksrc + i * rows * ks.s,
                     bytes);
          cp_async16(vd_s + i * rows * row_bytes, vsrc + i * rows * vs.s,
                     bytes);
        }
      }
    } else {
      for (int e = tid; e < 2 * n * hdp; e += NT) {
        const int which = e >= n * hdp, ew = e - which * n * hdp;
        const int r = ew / hdp, d = ew - r * hdp;
        T x = from_f<T>(0.f);
        if (d < hd) x = which ? vb[(t0 + r) * vs.s + d] : kb[(t0 + r) * ks.s + d];
        *reinterpret_cast<T*>((which ? vd : kd) + r * row_bytes +
                              d * sizeof(T)) = x;
      }
    }
    for (int t = tid; t < n; t += NT)
      cp_async4(smem_addr(pos_sh + st * ts + t), kpb + (t0 + t) * kp_s);
  };

  // the first stages - 1 tiles in flight (one commit group each, empty
  // past the last tile), then q and the running state
  for (int i = 0; i < stages - 1; ++i) {
    if (i < ntiles) stage(i);
    cp_async_commit();
  }
  for (int e = tid; e < G * hdp; e += NT) {
    const int g = e / hdp, d = e - g * hdp;
    q_sh[e] = d < hd ? to_f(q[ib * qs.b + (h0 + g) * qs.h + d]) : 0.f;
  }
  for (int e = tid; e < nsub * G * hd; e += NT) acc_sh[e] = 0.f;
  for (int g = tid; g < G; g += NT) {
    m_sh[g] = kNegInf;
    l_sh[g] = 0.f;
  }
  const int qp = qpos[ib * qp_b];
  const int cp = tid % ncp, sub = tid / ncp;   // P V: column pair, slots
  const bool two = 2 * cp + 1 < hd;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % stages;
    // tile `it` has landed: all but the stages - 2 newest groups are done
    if (stages == 4) {
      cp_async_wait<2>();
    } else if (stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // ... for every thread; tile it - 1 is consumed
    if (it + stages - 1 < ntiles) stage(it + stages - 1);
    cp_async_commit();
    const int n = min(ts, s_end - (s_begin + it * ts));
    const unsigned char* kt = kv_sh + 2 * st * tile_bytes;
    const unsigned char* vt = kt + tile_bytes;
    const float* m_old = m_sh + (it & 1) * G;
    float* m_new = m_sh + ((it + 1) & 1) * G;

    // scores: TPS neighbouring threads a slot, each over every TPS-th
    // 16-byte chunk of its row, summed by shuffles; every head; a masked
    // slot is -inf (no max, probability 0)
    const int slot = tid / TPS;
    const int kp = slot < n ? pos_sh[st * ts + slot] : -1;
    const bool ok = slot < n && kp >= 0 && kp <= qp && qp - kp < opt.window;
    for (int g0 = 0; g0 < G; g0 += NH) {
      float dots[NH];
#pragma unroll
      for (int i = 0; i < NH; ++i) dots[i] = 0.f;
      if (ok) {
        const unsigned char* kr = kt + slot * row_bytes;
#pragma unroll 2
        for (int c = tid % TPS; c < nch; c += TPS) {
          float kx[EPC];
          chunk_to_f<T>(kr + c * 16, kx);
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            const float* qg = q_sh + min(g0 + i, G - 1) * hdp + c * EPC;
#pragma unroll
            for (int e = 0; e < EPC; ++e) dots[i] = fmaf(qg[e], kx[e], dots[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NH; ++i)
#pragma unroll
        for (int off = 1; off < TPS; off <<= 1)
          dots[i] += __shfl_xor_sync(kFull, dots[i], off);
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const int g = g0 + i;
        if (g >= G) break;
        const float x = ok ? score(dots[i], opt) : -INFINITY;
        if (tid % TPS == 0 && slot < ts) s_sh[g * ts + slot] = x;
        float mx = x;
#pragma unroll
        for (int off = 16; off; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        if (lane == 0) red_sh[g * NW + warp] = mx;
      }
    }
    __syncthreads();   // every head's warp maxima are in

    // probabilities: every thread derives each head's new max itself
    for (int g = 0; g < G; ++g) {
      float mx = m_old[g];
#pragma unroll
      for (int w = 0; w < NW; ++w)
        mx = fmaxf(mx, red_sh[g * NW + w]);
      float p = 0.f;
      if (tid < ts) {
        p = expf(s_sh[g * ts + tid] - mx);
        s_sh[g * ts + tid] = p;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
      if (lane == 0) sum_sh[g * NW + warp] = p;
      if (tid == g % NT) m_new[g] = mx;
    }
    __syncthreads();   // p, the sums and the new maxima are in

    for (int g = tid; g < G; g += NT) {
      float ps = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) ps += sum_sh[g * NW + w];
      l_sh[g] = l_sh[g] * expf(m_old[g] - m_new[g]) + ps;
    }
    if (sub < nsub) {
      const unsigned char* vc = vt + 2 * cp * sizeof(T);
      float* accs = acc_sh + sub * G * hd + 2 * cp;
      for (int g0 = 0; g0 < G; g0 += NH) {
        float a[NH][2];
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          const int g = min(g0 + i, G - 1);
          const float al = expf(m_old[g] - m_new[g]);
          a[i][0] = accs[g * hd] * al;
          a[i][1] = two ? accs[g * hd + 1] * al : 0.f;
        }
#pragma unroll 2
        for (int j = sub; j < n; j += nsub) {
          const float2 vv = pair_to_f<T>(vc + j * row_bytes);
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            const float pj = s_sh[min(g0 + i, G - 1) * ts + j];
            a[i][0] = fmaf(pj, vv.x, a[i][0]);
            a[i][1] = fmaf(pj, vv.y, a[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          const int g = g0 + i;
          if (g >= G) break;
          accs[g * hd] = a[i][0];
          if (two) accs[g * hd + 1] = a[i][1];
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the loop (empty groups)

  // partials: part = acc [B][KV][splits][G][hd], then (from the next
  // multiple of four floats) ml [B][KV][splits][G][2]
  const long long pair = (long long)ib * KV + ikv;
  float* part_acc = part;
  float* part_ml =
      part + (((long long)gridDim.z * KV * splits * G * hd + 3) & ~3ll);
  const long long mine = (pair * splits + split) * G;
  const float* m_fin = m_sh + (ntiles & 1) * G;
  __syncthreads();   // the running state is final
  for (int g = tid; g < G; g += NT)
    reinterpret_cast<float2*>(part_ml)[mine + g] =
        make_float2(m_fin[g], l_sh[g]);
  for (int e = tid; e < G * hd; e += NT) {
    float a = 0.f;
    for (int s = 0; s < nsub; ++s) a += acc_sh[s * G * hd + e];
    part_acc[mine * hd + e] = a;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(counters + pair, 1);
    *last_sh = done == splits - 1;
    if (*last_sh) {
      counters[pair] = 0;   // ready for the next launch
      __threadfence();
    }
  }
  __syncthreads();
  if (!*last_sh) return;

  // the last block merges every split in split order; partial (s, g) of
  // this (row, KV head) is number first + s G + g
  const long long first = pair * splits * G;
  const int SG = splits * G;
  float* w_sh = reinterpret_cast<float*>(kv_sh);   // [splits][G] m, then weight
  float* wl_sh = w_sh + SG;                        // [splits][G] l, then w l
  float* mg_sh = wl_sh + SG;                       // [G] max m over the splits
  float* lg_sh = mg_sh + G;                        // [G] divisor
  for (int i = tid; i < SG; i += NT) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + first + i);
    w_sh[i] = ml.x;
    wl_sh[i] = ml.y;
  }
  __syncthreads();
  for (int g = tid; g < G; g += NT) {
    float M = kNegInf;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) M = fmaxf(M, w_sh[s * G + g]);
    mg_sh[g] = M;
  }
  __syncthreads();
  for (int i = tid; i < SG; i += NT) {
    const float w = expf(w_sh[i] - mg_sh[i % G]);
    w_sh[i] = w;
    wl_sh[i] *= w;
  }
  __syncthreads();
  for (int g = tid; g < G; g += NT) {
    float L = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) L += wl_sh[s * G + g];
    lg_sh[g] = L > 0.f ? L : 1.f;
  }
  __syncthreads();
  const long long step = (long long)G * hd;   // floats between splits
  T* ob = o + ib * os.b + h0 * os.h;
  if (hd % 4 == 0) {   // four columns a thread, 16-byte loads
    const int nq = hd / 4;
    for (int e = tid; e < G * nq; e += NT) {
      const int g = e / nq, d = (e - g * nq) * 4;
      const float4* pa =
          reinterpret_cast<const float4*>(part_acc + (first + g) * hd + d);
      float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < splits; ++s) {
        const float w = w_sh[s * G + g];
        const float4 a = __ldcg(pa + s * (step / 4));
        O.x = fmaf(w, a.x, O.x);
        O.y = fmaf(w, a.y, O.y);
        O.z = fmaf(w, a.z, O.z);
        O.w = fmaf(w, a.w, O.w);
      }
      const float div = lg_sh[g];
      T* out = ob + g * os.h + d;
      out[0] = from_f<T>(O.x / div);
      out[1] = from_f<T>(O.y / div);
      out[2] = from_f<T>(O.z / div);
      out[3] = from_f<T>(O.w / div);
    }
  } else {
    for (int e = tid; e < G * hd; e += NT) {
      const int g = e / hd, d = e - g * hd;
      const float* pa = part_acc + (first + g) * hd + d;
      float O = 0.f;
#pragma unroll 8
      for (int s = 0; s < splits; ++s)
        O = fmaf(w_sh[s * G + g], __ldcg(pa + s * step), O);
      ob[g * os.h + d] = from_f<T>(O / lg_sh[g]);
    }
  }
}

template <typename T, int NH, int TPS>
int launch_decode_nh(int G, size_t smem, dim3 grid, cudaStream_t stream,
                     const void* q, const void* k, const void* v,
                     const void* qpos, const void* kpos, void* o, void* part,
                     void* counters, int C, int hd, int per, int ts, int vec,
                     int stages, Strides qs, Strides ks, Strides vs,
                     long long qp_b, long long kp_b, long long kp_s,
                     Strides os, Opts opt) {
  static int reserved[kMaxDevices];
  const cudaError_t err =
      reserve_smem(flash_decode_kernel<T, NH, TPS>, smem, reserved);
  if (err != cudaSuccess) return int(err);
  flash_decode_kernel<T, NH, TPS><<<grid, kDecSlots * TPS, smem,
                                    stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qpos,
      (const int*)kpos, (T*)o, (float*)part, (int*)counters, G, C, hd, per,
      ts, vec, stages, qs, ks, vs, qp_b, kp_b, kp_s, os, opt);
  return int(cudaGetLastError());
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* qpos, const void* kpos, void* o, void* part,
                  void* counters, int B, int H, int KV, int C, int hd,
                  int splits, int per, int ts, int tps, int vec, Strides qs,
                  Strides ks, Strides vs, long long qp_b, long long kp_b,
                  long long kp_s, Strides os, Opts opt,
                  cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  const int G = H / KV, nch = (hd + EPC - 1) / EPC;
  if (hd < 1 || hd > 256 || splits < 1 || per < 1 || ts < 32 ||
      ts > kDecSlots || (tps != 1 && (tps != 4 || G < 3)))
    return int(cudaErrorInvalidValue);
  const int row_bytes = (nch + 1) * 16, stages = dec_stages(ts * row_bytes);
  const int tiles = (per + ts - 1) / ts;   // most a split holds
  const size_t smem = dec_smem_bytes(
      G, hd, nch * EPC, kDecSlots * tps / ((hd + 1) / 2),
      kDecSlots * tps / 32, ts, row_bytes, tiles < stages ? tiles : stages,
      splits);
  const dim3 grid(splits, KV, B);
#define RT_DECODE(NH, TPS)                                                  \
  launch_decode_nh<T, NH, TPS>(G, smem, grid, stream, q, k, v, qpos, kpos,  \
                               o, part, counters, C, hd, per, ts, vec,      \
                               stages, qs, ks, vs, qp_b, kp_b, kp_s, os,    \
                               opt)
  if (G <= 1) return RT_DECODE(1, 1);
  if (G <= 2) return RT_DECODE(2, 1);
  if (tps == 1) {
    if (G <= 4) return RT_DECODE(4, 1);
    if (G <= 6) return RT_DECODE(6, 1);
    return RT_DECODE(8, 1);
  }
  if (G <= 4) return RT_DECODE(4, 4);
  if (G <= 6) return RT_DECODE(6, 4);
  return RT_DECODE(8, 4);
#undef RT_DECODE
}

}  // namespace

extern "C" {

// q [B, H, SQ, hd], k and v [B, KV, SK, hd], o like q, each through its
// (batch, head, seq) element strides; dtype 0 f32, 1 f16, 2 bf16;
// window INT_MAX for none, softcap 0 for none. The CUDA-core route: any
// dtype, head_dim 1 .. 256.
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

// The same function on the tensor-core route: dtype f16 or bf16, head_dim
// 64 or 128, every base pointer and (batch, head, seq) stride of q, k, v
// and o a multiple of 16 bytes (the wrapper checks).
int rt_flash_attention_tc(const void* q, const void* k, const void* v,
                          void* o, int B, int H, int KV, int SQ, int SK,
                          int hd, long long q_b, long long q_h, long long q_s,
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
    case kF16:
      return fwd_tc_for_width<__half>(q, k, v, o, B, H, KV, SQ, SK, hd, qs,
                                      ks, vs, os, opt, s);
    case kBF16:
      return fwd_tc_for_width<__nv_bfloat16>(q, k, v, o, B, H, KV, SQ, SK,
                                             hd, qs, ks, vs, os, opt, s);
  }
  return int(cudaErrorInvalidValue);
}

// q [B, H, 1, hd], k and v [B, KV, C, hd] and o like q through their
// strides; qpos [B, 1] and kpos [B, C] int32 through theirs. part: f32
// scratch of n * hd rounded up to a multiple of 4, plus 2 n, for
// n = B * H * splits; counters: B * KV ints,
// zero before the first launch (each launch leaves them zero). Slots
// [s * per, (s + 1) * per) are split s, taken in tiles of ts slots (32, 64
// or 128) with tps threads a slot (1, or 4 when H / KV >= 3). vec: 1
// when k and v rows start 16-byte aligned (16-byte copies), else 0.
int rt_flash_decode(const void* q, const void* k, const void* v,
                    const void* qpos, const void* kpos, void* o, void* part,
                    void* counters, int B, int H, int KV, int C, int hd,
                    int splits, int per, int ts, int tps, int vec,
                    long long q_b,
                    long long q_h, long long k_b, long long k_h,
                    long long k_s, long long v_b, long long v_h,
                    long long v_s, long long qp_b, long long kp_b,
                    long long kp_s, long long o_b, long long o_h, float scale,
                    int window, float softcap, int dtype, void* stream) {
  const Strides qs{q_b, q_h, 0}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, 0};
  const Opts opt{scale, softcap, window};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch_decode<float>(q, k, v, qpos, kpos, o, part, counters, B,
                                  H, KV, C, hd, splits, per, ts, tps, vec, qs,
                                  ks, vs, qp_b, kp_b, kp_s, os, opt, s);
    case kF16:
      return launch_decode<__half>(q, k, v, qpos, kpos, o, part, counters, B,
                                   H, KV, C, hd, splits, per, ts, tps, vec,
                                   qs, ks, vs, qp_b, kp_b, kp_s, os, opt, s);
    case kBF16:
      return launch_decode<__nv_bfloat16>(
          q, k, v, qpos, kpos, o, part, counters, B, H, KV, C, hd, splits,
          per, ts, tps, vec, qs, ks, vs, qp_b, kp_b, kp_s, os, opt, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
