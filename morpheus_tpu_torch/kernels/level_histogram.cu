// Per-level histogram of hash-grid embedding cotangents, for Hopper (sm_90a).
//
// Replaces the TPU kernel morpheus_tpu/ops/hist_pallas.py::level_histogram
// (kernel body _kernel, a one-hot MXU matmul per update block). Same function
// and precision contract:
//
//   out[level_starts[l] + idx[l, i], c] += float(vals[l * Np + i, c])
//
// accumulated in f32; bf16 payloads are rounded once by the caller and widened
// here on the way in. The output is the (T, C) table layout itself, so the
// per-level slice-and-concatenate of take_hist_rows folds into the kernel.
//
// What bounds it on this card: the work is one f32 add per (update, channel),
// so arithmetic is negligible; the bytes are the index and payload streams read
// once and the table written once, and the real limit is atomic throughput in
// L2 under contention (hashed levels map ~300k updates onto 32k rows). This
// first version gives each thread one (update, channel) pair, so the payload
// reads are contiguous across a warp and neighbouring lanes add into
// neighbouring words of one table row; one grid row (blockIdx.y) per level
// keeps the level's start uniform and the index math 32-bit. It atomicAdds
// straight into the f32 table in device memory. Zero payloads are skipped (the
// table starts at +0, so skipping them is exact) - that drops the rows of
// levels masked by the coarse-to-fine schedule. A privatized per-level
// shared-memory histogram, and warp aggregation for streams that pile onto one
// slot, are the next steps.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// and called through the plain C entry points below (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 64

struct LevelStarts {
  int64_t v[MAX_LEVELS];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void level_histogram_kernel(const int32_t* __restrict__ idx,
                                       const T* __restrict__ vals,
                                       LevelStarts starts,
                                       float* __restrict__ out,
                                       int64_t n_per_level, int n_chan) {
  const int level = blockIdx.y;
  const int64_t first = (int64_t)level * n_per_level;   // first update of level
  const uint32_t n_pairs = (uint32_t)(n_per_level * n_chan);
  const int32_t* lidx = idx + first;
  const T* lvals = vals + first * n_chan;
  float* lout = out + starts.v[level] * n_chan;
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n_pairs;
       j += gridDim.x * blockDim.x) {
    const float x = widen(lvals[j]);
    if (x != 0.0f) {
      const uint32_t i = j / (uint32_t)n_chan;
      const uint32_t c = j - i * (uint32_t)n_chan;
      atomicAdd(lout + (int64_t)lidx[i] * n_chan + c, x);
    }
  }
}

template <typename T>
static int launch(const int32_t* idx, const T* vals, const int64_t* level_starts,
                  int n_levels, int64_t n_per_level, int n_chan, float* out,
                  cudaStream_t stream) {
  // one level's (update, channel) pairs are counted in 32 bits
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_chan < 1 || n_per_level < 0 ||
      n_per_level * n_chan >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  LevelStarts starts;
  for (int l = 0; l < n_levels; ++l) starts.v[l] = level_starts[l];
  const int64_t n_pairs = n_per_level * n_chan;
  if (n_pairs == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n_pairs + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond that
  const dim3 grid((unsigned)blocks, (unsigned)n_levels);
  level_histogram_kernel<T><<<grid, threads, 0, stream>>>(idx, vals, starts, out,
                                                          n_per_level, n_chan);
  return (int)cudaGetLastError();
}

extern "C" {

int level_histogram_f32(const void* idx, const void* vals, const int64_t* level_starts,
                        int n_levels, int64_t n_per_level, int n_chan, void* out,
                        void* stream) {
  return launch<float>((const int32_t*)idx, (const float*)vals, level_starts, n_levels,
                       n_per_level, n_chan, (float*)out, (cudaStream_t)stream);
}

int level_histogram_bf16(const void* idx, const void* vals, const int64_t* level_starts,
                         int n_levels, int64_t n_per_level, int n_chan, void* out,
                         void* stream) {
  return launch<__nv_bfloat16>((const int32_t*)idx, (const __nv_bfloat16*)vals,
                               level_starts, n_levels, n_per_level, n_chan, (float*)out,
                               (cudaStream_t)stream);
}

}  // extern "C"
