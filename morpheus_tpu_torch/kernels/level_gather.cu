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
// whole table into bf16 planes folds away. Rows outside the table read as 0.
//
// What bounds it on this card: the index stream read once, the table read once
// (it is 6.7 MB at the bench width and stays in the 50 MB L2) and the (N, C)
// output written once; the output is the largest stream (84 MB at C=4) and is
// read once, later. For C = 2 and 4 (the forward of mxu_rows, the occupancy
// refresh's sdf-only 'nearest' queries, the double backward's gather of the
// cotangent table) one thread takes whole rows: it reads the index once, loads
// the row with one 8- or 16-byte read-only load (__ldg, L2-resident), forms the
// split in registers and writes the row with one 8- or 16-byte streaming store
// (__stcs, so the output does not push the table out of L2). Each thread keeps
// UNROLL updates in flight (all index loads, then all row loads, then all
// stores), and the grid covers the stream once: N / (256 * UNROLL) blocks, a few
// waves of the 132 SMs at the step's shapes. One grid row (blockIdx.y) per
// level keeps the level's start uniform. Any other C, or a table or output not
// aligned for the vector access, takes the generic kernel of the same family:
// one thread per (update, channel).
//
// A bf16 table (the bfloat16 mixed-precision policy casts the table before the
// gather, as morpheus_tpu/ops/hashgrid.py:505-506 does) takes the entry
// level_gather_bf16: every split of a bf16 value is the value itself (t2 = t3 =
// 0), so S does not matter and each row is read as C bf16 values (a 4- or
// 8-byte load) and widened to f32 exactly. The bf16 table is half the bytes;
// the output, the largest stream, is the same.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// and called through the plain C entry points below (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 64

constexpr int THREADS = 256;
constexpr int UNROLL = 4;   // updates in flight per thread

struct LevelStarts {
  int64_t v[MAX_LEVELS];
};

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the S-plane bf16 split of one value, summed back in f32: (t1 + t2) + t3
template <int S>
__device__ __forceinline__ float split(float x) {
  float y = bf16_rn(x);
  if (S == 3) {
    const float r1 = __fsub_rn(x, y);
    const float t2 = bf16_rn(r1);
    const float t3 = bf16_rn(__fsub_rn(r1, t2));
    y = __fadd_rn(__fadd_rn(y, t2), t3);
  }
  return y;
}

template <int C> struct Row;
template <> struct Row<2> {
  using T = float2;
  template <int S> static __device__ __forceinline__ T split_row(T x) {
    return make_float2(split<S>(x.x), split<S>(x.y));
  }
};
template <> struct Row<4> {
  using T = float4;
  template <int S> static __device__ __forceinline__ T split_row(T x) {
    return make_float4(split<S>(x.x), split<S>(x.y), split<S>(x.z), split<S>(x.w));
  }
};

// how the rows kernel reads one table row and turns it into C f32 outputs:
// F32Rows splits an f32 row into S bf16 planes and sums them back; Bf16Rows
// widens a row of C bf16 values (element 0 in the low half of each word)
template <int C, int S> struct F32Rows {
  using In = typename Row<C>::T;
  using Out = typename Row<C>::T;
  static __device__ __forceinline__ Out convert(In x) {
    return Row<C>::template split_row<S>(x);
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int C> struct Bf16Rows;
template <> struct Bf16Rows<2> {
  using In = uint32_t;
  using Out = float2;
  static __device__ __forceinline__ Out convert(In x) {
    return make_float2(bf16_lo(x), bf16_hi(x));
  }
};
template <> struct Bf16Rows<4> {
  using In = uint2;
  using Out = float4;
  static __device__ __forceinline__ Out convert(In x) {
    return make_float4(bf16_lo(x.x), bf16_hi(x.x), bf16_lo(x.y), bf16_hi(x.y));
  }
};

template <typename R>
__global__ void __launch_bounds__(THREADS)
level_gather_rows_kernel(const int32_t* __restrict__ idx, const void* __restrict__ table,
                         LevelStarts starts, float* __restrict__ out, int64_t n_per_level,
                         int64_t n_rows) {
  using In = typename R::In;
  using Vec = typename R::Out;
  const int level = blockIdx.y;
  const int32_t* lidx = idx + (int64_t)level * n_per_level;
  Vec* lout = reinterpret_cast<Vec*>(out) + (int64_t)level * n_per_level;
  const In* rows = reinterpret_cast<const In*>(table);
  const int64_t start = starts.v[level];
  const int64_t base = (int64_t)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;

  int64_t row[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = base + u * THREADS;
    row[u] = i < n_per_level ? start + __ldcs(lidx + i) : -1;
  }
  In x[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (row[u] >= 0 && row[u] < n_rows) {
      x[u] = __ldg(rows + row[u]);
    } else {
      x[u] = In{};
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < n_per_level) __stcs(lout + i, R::convert(x[u]));
  }
}

// one table value as f32: split into S planes (f32 table), widened (bf16)
template <int S>
__device__ __forceinline__ float value(const float* table, int64_t k) {
  return split<S>(table[k]);
}
template <int S>
__device__ __forceinline__ float value(const __nv_bfloat16* table, int64_t k) {
  return __bfloat162float(table[k]);
}

// generic: one thread per (update, channel)
template <int S, typename Tab>
__global__ void __launch_bounds__(THREADS)
level_gather_kernel(const int32_t* __restrict__ idx, const Tab* __restrict__ table,
                    LevelStarts starts, float* __restrict__ out, int64_t n_per_level,
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
    lout[j] = row >= 0 && row < n_rows ? value<S>(table, row * n_chan + c) : 0.0f;
  }
}

static bool aligned(const void* p, size_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

template <typename R>
static void launch_rows(const int32_t* idx, const void* table, const LevelStarts& starts,
                        int n_levels, int64_t n_per_level, int64_t n_rows, float* out,
                        cudaStream_t stream) {
  const int64_t blocks = (n_per_level + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const dim3 grid((unsigned)blocks, (unsigned)n_levels);
  level_gather_rows_kernel<R>
      <<<grid, THREADS, 0, stream>>>(idx, table, starts, out, n_per_level, n_rows);
}

// Tab is float (S = 1 or 3) or __nv_bfloat16 (S unused)
template <int S, typename Tab>
static int launch(const int32_t* idx, const Tab* table, const int64_t* level_starts,
                  int n_levels, int64_t n_per_level, int n_chan, int64_t n_rows, float* out,
                  cudaStream_t stream) {
  // one level's (update, channel) pairs are counted in 32 bits
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_chan < 1 || n_per_level < 0 ||
      n_rows < 0 || n_per_level * n_chan >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  LevelStarts starts;
  for (int l = 0; l < n_levels; ++l) starts.v[l] = level_starts[l];
  if (n_per_level == 0) return 0;
  constexpr bool bf16 = sizeof(Tab) == 2;
  const bool vec = aligned(table, n_chan * sizeof(Tab)) &&
                   aligned(out, n_chan * sizeof(float));
  if (vec && n_chan == 2) {
    if (bf16) launch_rows<Bf16Rows<2>>(idx, table, starts, n_levels, n_per_level, n_rows,
                                       out, stream);
    else launch_rows<F32Rows<2, S>>(idx, table, starts, n_levels, n_per_level, n_rows,
                                    out, stream);
  } else if (vec && n_chan == 4) {
    if (bf16) launch_rows<Bf16Rows<4>>(idx, table, starts, n_levels, n_per_level, n_rows,
                                       out, stream);
    else launch_rows<F32Rows<4, S>>(idx, table, starts, n_levels, n_per_level, n_rows,
                                    out, stream);
  } else {
    const int64_t n_pairs = n_per_level * n_chan;
    int64_t blocks = (n_pairs + THREADS - 1) / THREADS;
    if (blocks > 4096) blocks = 4096;  // grid-stride beyond that
    const dim3 grid((unsigned)blocks, (unsigned)n_levels);
    level_gather_kernel<S, Tab><<<grid, THREADS, 0, stream>>>(
        idx, table, starts, out, n_per_level, n_chan, n_rows);
  }
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

int level_gather_bf16(const void* idx, const void* table, const int64_t* level_starts,
                      int n_levels, int64_t n_per_level, int n_chan, int64_t n_rows, void* out,
                      void* stream) {
  return launch<1>((const int32_t*)idx, (const __nv_bfloat16*)table, level_starts, n_levels,
                   n_per_level, n_chan, n_rows, (float*)out, (cudaStream_t)stream);
}

}  // extern "C"
