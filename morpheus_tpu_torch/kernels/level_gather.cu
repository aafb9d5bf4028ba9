// Per-level gather of hash-grid table rows through a bf16 split, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel morpheus_tpu/ops/gather_pallas.py::level_gather
// (kernel body _kernel, a factored one-hot MXU matmul over per-level tables
// that pack_level_table repacks into (L, T/128, 128*C) bf16 planes on every
// call). Same function and precision contract:
//
//   x  = table[level_starts[l] + idx[l, i], c]
//   t1 = bf16_rn(x), t2 = bf16_rn(x - t1), t3 = bf16_rn((x - t1) - t2)
//   out[l * Np + i, c] = t1                  (S = 1: the bf16 payload)
//                      = (t1 + t2) + t3      (S = 3: f32 to within one ulp)
//
// with every difference and sum taken in f32, round to nearest even, in that
// order, so the result equals level_gather(pack_level_table(...)) bit for bit.
// The TPU's one-hot selection exists to keep the table in VMEM and off the
// TPU's slow random access; it is not copied. The kernel reads the f32 (T, C)
// table itself and splits only the value it needs, so the per-call repack of the
// whole table into bf16 planes folds away.
//
// What bounds it on this card: the index stream read once, the table read once
// (it is 6.7 MB at the bench width and stays in the 50 MB L2) and the (N, C)
// output written once; the output is the largest stream. One thread per
// (update, channel): neighbouring lanes read neighbouring words of one table row
// and write neighbouring words of the output, so the output writes are
// coalesced and a warp's index reads are broadcast. One grid row (blockIdx.y)
// per level keeps the level's start uniform and the index math 32-bit. Rows
// outside the table read as 0.
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

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int S>
__global__ void level_gather_kernel(const int32_t* __restrict__ idx,
                                    const float* __restrict__ table, LevelStarts starts,
                                    float* __restrict__ out, int64_t n_per_level,
                                    int n_chan, int64_t n_rows) {
  const int level = blockIdx.y;
  const int64_t first = (int64_t)level * n_per_level;   // first update of level
  const uint32_t n_pairs = (uint32_t)(n_per_level * n_chan);
  const int32_t* lidx = idx + first;
  float* lout = out + first * n_chan;
  const int64_t start = starts.v[level];
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n_pairs;
       j += gridDim.x * blockDim.x) {
    const uint32_t i = j / (uint32_t)n_chan;
    const uint32_t c = j - i * (uint32_t)n_chan;
    const int64_t row = start + lidx[i];
    float y = 0.0f;
    if (row >= 0 && row < n_rows) {
      const float x = table[row * n_chan + c];
      y = bf16_rn(x);
      if (S == 3) {
        const float r1 = __fsub_rn(x, y);
        const float t2 = bf16_rn(r1);
        const float t3 = bf16_rn(__fsub_rn(r1, t2));
        y = __fadd_rn(__fadd_rn(y, t2), t3);
      }
    }
    lout[j] = y;
  }
}

template <int S>
static int launch(const int32_t* idx, const float* table, const int64_t* level_starts,
                  int n_levels, int64_t n_per_level, int n_chan, int64_t n_rows, float* out,
                  cudaStream_t stream) {
  // one level's (update, channel) pairs are counted in 32 bits
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_chan < 1 || n_per_level < 0 ||
      n_rows < 0 || n_per_level * n_chan >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  LevelStarts starts;
  for (int l = 0; l < n_levels; ++l) starts.v[l] = level_starts[l];
  const int64_t n_pairs = n_per_level * n_chan;
  if (n_pairs == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n_pairs + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond that
  const dim3 grid((unsigned)blocks, (unsigned)n_levels);
  level_gather_kernel<S><<<grid, threads, 0, stream>>>(idx, table, starts, out, n_per_level,
                                                       n_chan, n_rows);
  return (int)cudaGetLastError();
}

extern "C" {

int level_gather_s1(const void* idx, const void* table, const int64_t* level_starts,
                    int n_levels, int64_t n_per_level, int n_chan, int64_t n_rows, void* out,
                    void* stream) {
  return launch<1>((const int32_t*)idx, (const float*)table, level_starts, n_levels,
                   n_per_level, n_chan, n_rows, (float*)out, (cudaStream_t)stream);
}

int level_gather_s3(const void* idx, const void* table, const int64_t* level_starts,
                    int n_levels, int64_t n_per_level, int n_chan, int64_t n_rows, void* out,
                    void* stream) {
  return launch<3>((const int32_t*)idx, (const float*)table, level_starts, n_levels,
                   n_per_level, n_chan, n_rows, (float*)out, (cudaStream_t)stream);
}

}  // extern "C"
