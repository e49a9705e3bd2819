// δ-CRDT versioned-chunk join and chunk digest kernels for Hopper (sm_90a).
//
// Four kernels, each the CUDA counterpart of one Pallas TPU kernel in
// src/repro/kernels/delta_join.py. All four are bound by device-memory
// bandwidth: they do a compare, a select and (for the digests) two float
// operations per element, far below the ~20 operations per byte at which
// an H100 stops being memory bound. The design answer is the same for
// all four: read each needed byte once with 16-byte vector loads, keep
// the merged row in registers while it is reduced, and write each output
// byte once.
//
// Layout: values [n, chunk] row-major (f32, f16 or bf16), versions [n]
// int32. A "unit" is the load granule: a 16-byte uint4 when the row and
// the base pointers are 16-byte aligned (the wrapper decides), else one
// element. Ragged n needs no padding: a warp or block whose row lies past
// the end returns before touching memory.
//
// Every entry point is a plain C function that launches on the stream it
// is given and returns cudaGetLastError(), so a refused launch surfaces in
// the Python wrapper instead of being lost.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 256;      // warp-per-row kernels: 8 rows a block
constexpr int kScatterThreads = 32;   // scatter_join: one warp-block a row

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

// max that propagates NaN, as the plain version's amax does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Fold one load unit U (uint4 or a single T) into the running max|x| and
// sum of squares, converting each element to f32 first.
template <typename T, typename U>
__device__ __forceinline__ void accum(const U& u, float& mx, float& ss) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < int(sizeof(U) / sizeof(T)); ++k) {
    float f = to_f<T>(e[k]);
    mx = nanmax(mx, fabsf(f));
    ss += f * f;
  }
}

__device__ __forceinline__ void warp_reduce(float& mx, float& ss) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    mx = nanmax(mx, __shfl_xor_sync(kFull, mx, off));
    ss += __shfl_xor_sync(kFull, ss, off);
  }
}

// ---------------------------------------------------------------------------
// delta_join — replaces delta_join (_join_kernel) of
// src/repro/kernels/delta_join.py. Bound: bytes. One warp per row: the
// warp reads both versions, then loads ONLY the winning side's row (the
// select needs no bytes of the losing row) and streams it to the output.
// Value bytes are copied untouched, so the kernel is dtype-agnostic and
// bit-exact by construction.
// ---------------------------------------------------------------------------
template <typename U>
__global__ void __launch_bounds__(kRowThreads)
delta_join_kernel(const U* __restrict__ av, const int* __restrict__ aver,
                  const U* __restrict__ bv, const int* __restrict__ bver,
                  U* __restrict__ ov, int* __restrict__ over, long long n,
                  int units) {
  const long long row =
      (long long)blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int ra = aver[row], rb = bver[row];
  const U* src = (rb > ra ? bv : av) + row * units;
  U* dst = ov + row * units;
  for (int u = lane; u < units; u += 32) dst[u] = src[u];
  if (lane == 0) over[row] = max(ra, rb);
}

// ---------------------------------------------------------------------------
// fused_join_digest — replaces fused_join_digest
// (_fused_join_digest_kernel). Bound: bytes. delta_join's warp-per-row
// select plus the digest of the merged row, reduced from the registers
// the row passes through on its way to the output: no second pass over
// device memory. Warp shuffles combine the 32 lanes' partial max|x|, Σx².
// ---------------------------------------------------------------------------
template <typename T, typename U>
__global__ void __launch_bounds__(kRowThreads)
fused_join_digest_kernel(const U* __restrict__ av, const int* __restrict__ aver,
                         const U* __restrict__ bv, const int* __restrict__ bver,
                         U* __restrict__ ov, int* __restrict__ over,
                         float* __restrict__ oma, float* __restrict__ oss,
                         long long n, int units) {
  const long long row =
      (long long)blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;            // whole warp leaves together
  const int ra = aver[row], rb = bver[row];
  const U* src = (rb > ra ? bv : av) + row * units;
  U* dst = ov + row * units;
  float mx = 0.f, ss = 0.f;
  for (int u = lane; u < units; u += 32) {
    const U x = src[u];
    dst[u] = x;
    accum<T, U>(x, mx, ss);
  }
  warp_reduce(mx, ss);
  if (lane == 0) {
    over[row] = max(ra, rb);
    oma[row] = mx;
    oss[row] = ss;
  }
}

// ---------------------------------------------------------------------------
// chunk_digest — replaces chunk_digest (_digest_kernel). Bound: bytes.
// One warp per row, one read of each value, two f32 outputs a row.
// ---------------------------------------------------------------------------
template <typename T, typename U>
__global__ void __launch_bounds__(kRowThreads)
chunk_digest_kernel(const U* __restrict__ x, float* __restrict__ oma,
                    float* __restrict__ oss, long long n, int units) {
  const long long row =
      (long long)blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const U* src = x + row * units;
  float mx = 0.f, ss = 0.f;
  for (int u = lane; u < units; u += 32) accum<T, U>(src[u], mx, ss);
  warp_reduce(mx, ss);
  if (lane == 0) {
    oma[row] = mx;
    oss[row] = ss;
  }
}

// ---------------------------------------------------------------------------
// scatter_join — replaces scatter_join (_scatter_join_kernel). Bound:
// bytes of the r delta rows and the r resident rows they land on (plus
// the wrapper's copy of the columns, see below). One block — a single
// warp — per delta row; the block reads its own idx[i] (the TPU kernel
// had it prefetched as a scalar). A one-warp block reduces each row in
// exactly the lane order of chunk_digest and fused_join_digest, so a
// row's Σx² does not depend on which kernel last wrote it (the resident
// top-k ranks on that column). The kernel reads the OLD resident columns
// and writes the NEW ones, which the wrapper has already filled with a
// copy of the old: every row no delta row targets keeps its value, the
// caller's old columns stay intact (snapshot semantics), and pad rows —
// which all target one free row with ⊥ versions — write identical bytes
// without any block reading what another block wrote.
// ---------------------------------------------------------------------------
template <typename T, typename U>
__global__ void __launch_bounds__(kScatterThreads)
scatter_join_kernel(const U* __restrict__ vals_old,
                    const int* __restrict__ vers_old,
                    const int* __restrict__ idx, const U* __restrict__ dvals,
                    const int* __restrict__ dvers, U* __restrict__ vals_new,
                    int* __restrict__ vers_new, float* __restrict__ ma_new,
                    float* __restrict__ ss_new, int units) {
  const long long i = blockIdx.x;
  const long long row = idx[i];
  const int lane = threadIdx.x;
  const int ra = vers_old[row], rb = dvers[i];
  const U* src = rb > ra ? dvals + i * units : vals_old + row * units;
  U* dst = vals_new + row * units;
  float mx = 0.f, ss = 0.f;
  for (int u = lane; u < units; u += 32) {
    const U x = src[u];
    dst[u] = x;
    accum<T, U>(x, mx, ss);
  }
  warp_reduce(mx, ss);
  if (lane == 0) {
    vers_new[row] = max(ra, rb);
    ma_new[row] = mx;
    ss_new[row] = ss;
  }
}

inline unsigned row_blocks(long long n) {
  return unsigned((n + kRowThreads / 32 - 1) / (kRowThreads / 32));
}

// Dispatch on (value dtype, vectorized?) for the kernels that read values
// as numbers. `vec` means rows are whole 16-byte units at aligned bases.
template <template <typename, typename> class Launch, typename... Args>
int dispatch(int dtype, int vec, long long row_elems, Args... args) {
  switch (dtype) {
    case kF32:
      return vec ? Launch<float, uint4>::run(int(row_elems * 4 / 16), args...)
                 : Launch<float, float>::run(int(row_elems), args...);
    case kF16:
      return vec ? Launch<__half, uint4>::run(int(row_elems * 2 / 16), args...)
                 : Launch<__half, __half>::run(int(row_elems), args...);
    case kBF16:
      return vec ? Launch<__nv_bfloat16, uint4>::run(int(row_elems * 2 / 16),
                                                     args...)
                 : Launch<__nv_bfloat16, __nv_bfloat16>::run(int(row_elems),
                                                             args...);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, typename U>
struct FusedLaunch {
  static int run(int units, const void* av, const void* aver, const void* bv,
                 const void* bver, void* ov, void* over, void* oma, void* oss,
                 long long n, cudaStream_t s) {
    fused_join_digest_kernel<T, U><<<row_blocks(n), kRowThreads, 0, s>>>(
        (const U*)av, (const int*)aver, (const U*)bv, (const int*)bver,
        (U*)ov, (int*)over, (float*)oma, (float*)oss, n, units);
    return int(cudaGetLastError());
  }
};

template <typename T, typename U>
struct DigestLaunch {
  static int run(int units, const void* x, void* oma, void* oss, long long n,
                 cudaStream_t s) {
    chunk_digest_kernel<T, U><<<row_blocks(n), kRowThreads, 0, s>>>(
        (const U*)x, (float*)oma, (float*)oss, n, units);
    return int(cudaGetLastError());
  }
};

template <typename T, typename U>
struct ScatterLaunch {
  static int run(int units, const void* vals_old, const void* vers_old,
                 const void* idx, const void* dvals, const void* dvers,
                 void* vals_new, void* vers_new, void* ma_new, void* ss_new,
                 long long r, cudaStream_t s) {
    scatter_join_kernel<T, U><<<unsigned(r), kScatterThreads, 0, s>>>(
        (const U*)vals_old, (const int*)vers_old, (const int*)idx,
        (const U*)dvals, (const int*)dvers, (U*)vals_new, (int*)vers_new,
        (float*)ma_new, (float*)ss_new, units);
    return int(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

// elem_bytes is 2 or 4; vec as above. Value bytes are only copied.
int rt_delta_join(const void* av, const void* aver, const void* bv,
                  const void* bver, void* ov, void* over, long long n,
                  long long row_elems, int elem_bytes, int vec,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    delta_join_kernel<uint4><<<row_blocks(n), kRowThreads, 0, s>>>(
        (const uint4*)av, (const int*)aver, (const uint4*)bv,
        (const int*)bver, (uint4*)ov, (int*)over, n,
        int(row_elems * elem_bytes / 16));
  } else if (elem_bytes == 4) {
    delta_join_kernel<uint32_t><<<row_blocks(n), kRowThreads, 0, s>>>(
        (const uint32_t*)av, (const int*)aver, (const uint32_t*)bv,
        (const int*)bver, (uint32_t*)ov, (int*)over, n, int(row_elems));
  } else if (elem_bytes == 2) {
    delta_join_kernel<uint16_t><<<row_blocks(n), kRowThreads, 0, s>>>(
        (const uint16_t*)av, (const int*)aver, (const uint16_t*)bv,
        (const int*)bver, (uint16_t*)ov, (int*)over, n, int(row_elems));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int rt_fused_join_digest(const void* av, const void* aver, const void* bv,
                         const void* bver, void* ov, void* over, void* oma,
                         void* oss, long long n, long long row_elems,
                         int dtype, int vec, void* stream) {
  return dispatch<FusedLaunch>(dtype, vec, row_elems, av, aver, bv, bver, ov,
                               over, oma, oss, n, (cudaStream_t)stream);
}

int rt_chunk_digest(const void* x, void* oma, void* oss, long long n,
                    long long row_elems, int dtype, int vec, void* stream) {
  return dispatch<DigestLaunch>(dtype, vec, row_elems, x, oma, oss, n,
                                (cudaStream_t)stream);
}

int rt_scatter_join(const void* vals_old, const void* vers_old,
                    const void* idx, const void* dvals, const void* dvers,
                    void* vals_new, void* vers_new, void* ma_new,
                    void* ss_new, long long r, long long row_elems, int dtype,
                    int vec, void* stream) {
  return dispatch<ScatterLaunch>(dtype, vec, row_elems, vals_old, vers_old,
                                 idx, dvals, dvers, vals_new, vers_new,
                                 ma_new, ss_new, r, (cudaStream_t)stream);
}

}  // extern "C"
