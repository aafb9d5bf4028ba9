// Per-level histogram of hash-grid embedding cotangents, for Hopper (sm_90a).
//
// Replaces the TPU kernel morpheus_tpu/ops/hist_pallas.py::level_histogram
// (kernel body _kernel, a one-hot MXU matmul per update block). Same function
// and precision contract:
//
//   out[level_starts[l] + idx[l, i], c] += float(vals[l * Np + i, c])
//
// accumulated in f32. A bf16 payload is widened on the way in; an f32 payload
// with round_bf16 set is first rounded to bf16 (__float2bfloat16_rn, round to
// nearest even, as the caller's .to(bfloat16) would), so the rounding costs no
// launch and no bf16 copy of the stream. The output is the (T, C) table layout
// itself, so the per-level slice-and-concatenate of take_hist_rows folds into
// the kernel. Local rows below 0, and rows past the table's end, are dropped.
//
// What bounds it on this card: the work is one f32 add per (update, channel),
// so arithmetic is negligible; the bytes are the index and payload streams read
// once and the table written once, and the real limit is the atomics in L2:
// their count, and their serialisation when many land on one address. The
// encode lays a stream out as (level, corner, sample) with samples in ray
// order, so neighbouring updates of a coarse level often hit the same row.
// The design cuts the atomics three ways:
// - one lane per update row at C <= 4 (C/4 lanes of 4 channels for C = 16 and
//   32, the packed dense prefix), with one 8- or 16-byte payload load and one
//   vector atomic (atomicAdd on float2 / float4, global memory, compute
//   capability 9.x) in place of C scalar ones;
// - equal rows next to each other in the stream are summed inside the warp
//   first: a segmented inclusive scan over run heads (warp shuffles) sums every
//   run of equal rows in a 32-lane tile, and only the last lane of each run
//   adds;
// - each warp walks a contiguous chunk of its level, up to MAX_TILES tiles one
//   after the other, and carries the tile's last run in registers into the next
//   tile (the next tile's loads are issued before the current one is summed),
//   so a run that spans tiles costs one atomic per chunk. A stream on one slot
//   costs one atomic per warp chunk instead of 32 x C per tile. The chunk
//   shrinks with the stream, down to one tile, until the warps fill the card
//   once (WARPS_PER_SM on each SM): the step's small streams (16k-65k updates
//   a level) are bound by latency, and a long chunk would leave SMs idle.
// A run whose sum is exactly zero adds nothing (the table starts at +0, so
// skipping it is exact); that drops the rows of levels masked by the
// coarse-to-fine schedule. One grid row (blockIdx.y) per level keeps the
// level's start uniform and the index math 32-bit. Any other C, or a payload
// not aligned for the vector load, takes the generic kernel of the same
// family: one thread per (update, channel), one scalar atomic each.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// and called through the plain C entry points below (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 64
#define FULL_MASK 0xffffffffu

constexpr int THREADS = 256;
constexpr int MAX_TILES = 8;      // tiles of one warp's chunk, at most
constexpr int WARPS_PER_SM = 48;  // resident at ~40 registers a thread

struct LevelStarts {
  int64_t v[MAX_LEVELS];
};

template <bool ROUND>
__device__ __forceinline__ float widen(float v) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
template <bool ROUND>
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// two bf16 of one 32-bit word, the lower address in the low half
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

// V consecutive payload values as f32, one 4/8/16-byte streaming load
template <bool ROUND, int V>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcs(p);
  }
#pragma unroll
  for (int c = 0; c < V; ++c) v[c] = widen<ROUND>(v[c]);
}
template <bool ROUND, int V>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    unpack_bf16x2(t.x, v[0], v[1]);
    unpack_bf16x2(t.y, v[2], v[3]);
  } else if constexpr (V == 2) {
    unpack_bf16x2(__ldcs(reinterpret_cast<const unsigned int*>(p)), v[0], v[1]);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// one vector atomic of V channels; nothing for an all-zero sum
template <int V>
__device__ __forceinline__ void add_row(float* p, const float (&v)[V]) {
  bool zero = true;
#pragma unroll
  for (int c = 0; c < V; ++c) zero = zero && v[c] == 0.0f;
  if (zero) return;
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

template <typename T, int C, bool ROUND>
__global__ void __launch_bounds__(THREADS)
level_histogram_rows_kernel(const int32_t* __restrict__ idx, const T* __restrict__ vals,
                            LevelStarts starts, float* __restrict__ out,
                            int64_t n_per_level, int64_t n_rows, int tiles) {
  constexpr int V = C < 4 ? C : 4;   // channels of one lane
  constexpr int G = C / V;           // lanes of one update row
  constexpr int R = 32 / G;          // update rows of one tile
  const int lane = threadIdx.x & 31;
  const int slot = lane / G;         // this lane's row of the tile
  const int part = lane % G;         // its channels: part * V .. + V
  const int level = blockIdx.y;
  const int64_t warp = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int64_t begin = warp * (R * tiles);
  if (begin >= n_per_level) return;  // warp-uniform
  const int64_t end = begin + R * tiles < n_per_level ? begin + R * tiles : n_per_level;
  const int32_t* lidx = idx + (int64_t)level * n_per_level;
  const T* lvals = vals + (int64_t)level * n_per_level * C + part * V;
  float* lout = out + starts.v[level] * C + part * V;
  const int64_t row_end = n_rows - starts.v[level];   // local rows past the table

  // land one run's sum: local row `key` of this level
  auto land = [&](int key, const float (&v)[V]) {
    if (key >= 0 && key < row_end) add_row<V>(lout + (int64_t)key * C, v);
  };

  // the next tile's loads, issued before the current tile is summed
  int nkey = -1;
  float nv[V];
  auto fetch = [&](int64_t base) {
    const int64_t i = base + slot;
    if (i < end) {
      nkey = __ldcs(lidx + i);
      load_vals<ROUND, V>(lvals + i * C, nv);
    } else {                          // lanes past the end: a dropped run
      nkey = -1;
#pragma unroll
      for (int c = 0; c < V; ++c) nv[c] = 0.0f;
    }
  };
  fetch(begin);

  int carry_key = -1;                 // the previous tile's last run
  float carry[V];
#pragma unroll
  for (int c = 0; c < V; ++c) carry[c] = 0.0f;

  for (int64_t base = begin; base < end; base += R) {
    const int key = nkey;
    float v[V];
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = nv[c];
    if (base + R < end) fetch(base + R);

    const int prev = __shfl_up_sync(FULL_MASK, key, G);
    const int next = __shfl_down_sync(FULL_MASK, key, G);
    const bool tail = slot == R - 1 || next != key;
    const unsigned heads = __ballot_sync(FULL_MASK, slot == 0 || prev != key);
    // first row of this lane's run: the highest run head at or below it
    const int first = (31 - __clz(heads & (FULL_MASK >> (31 - lane)))) / G;
#pragma unroll
    for (int d = 1; d < R; d <<= 1) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float t = __shfl_up_sync(FULL_MASK, v[c], d * G);
        if (slot - d >= first) v[c] += t;
      }
    }

    // the carried run either continues into this tile's first run or is done
    const int first_key = __shfl_sync(FULL_MASK, key, part);
    if (first_key == carry_key) {
      if (first == 0) {
#pragma unroll
        for (int c = 0; c < V; ++c) v[c] += carry[c];
      }
    } else if (slot == 0) {
      land(carry_key, carry);
    }
    if (tail && slot != R - 1) land(key, v);
    const int last = (R - 1) * G + part;
    carry_key = __shfl_sync(FULL_MASK, key, last);
#pragma unroll
    for (int c = 0; c < V; ++c) carry[c] = __shfl_sync(FULL_MASK, v[c], last);
  }
  if (slot == 0) land(carry_key, carry);
}

// generic: one thread per (update, channel), one scalar atomic each
template <typename T, bool ROUND>
__global__ void __launch_bounds__(THREADS)
level_histogram_kernel(const int32_t* __restrict__ idx, const T* __restrict__ vals,
                       LevelStarts starts, float* __restrict__ out, int64_t n_per_level,
                       int n_chan, int64_t n_rows) {
  const int level = blockIdx.y;
  const int64_t first = (int64_t)level * n_per_level;   // first update of level
  const uint32_t n_pairs = (uint32_t)(n_per_level * n_chan);
  const int32_t* lidx = idx + first;
  const T* lvals = vals + first * n_chan;
  const int64_t start = starts.v[level];
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n_pairs;
       j += gridDim.x * blockDim.x) {
    const float x = widen<ROUND>(lvals[j]);
    if (x != 0.0f) {
      const uint32_t i = j / (uint32_t)n_chan;
      const uint32_t c = j - i * (uint32_t)n_chan;
      const int32_t key = lidx[i];
      const int64_t row = start + key;
      if (key >= 0 && row < n_rows) atomicAdd(out + row * n_chan + c, x);
    }
  }
}

template <typename T, int C, bool ROUND>
static void launch_rows(const int32_t* idx, const T* vals, const LevelStarts& starts,
                        int n_levels, int64_t n_per_level, int64_t n_rows, float* out,
                        cudaStream_t stream) {
  constexpr int R = 32 / (C < 4 ? 1 : C / 4);
  static int sms = 0;               // one card per process
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t level_tiles = (n_per_level + R - 1) / R;
  const int64_t fill = (int64_t)sms * WARPS_PER_SM;   // warps that fill the card once
  int64_t tiles = (level_tiles * n_levels + fill - 1) / fill;
  tiles = tiles < 1 ? 1 : tiles > MAX_TILES ? MAX_TILES : tiles;
  const int64_t warps = (level_tiles + tiles - 1) / tiles;
  const int64_t blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  const dim3 grid((unsigned)blocks, (unsigned)n_levels);
  level_histogram_rows_kernel<T, C, ROUND><<<grid, THREADS, 0, stream>>>(
      idx, vals, starts, out, n_per_level, n_rows, (int)tiles);
}

static bool aligned(const void* p, size_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

template <typename T, bool ROUND>
static int launch(const int32_t* idx, const T* vals, const int64_t* level_starts,
                  int n_levels, int64_t n_per_level, int n_chan, int64_t n_rows, float* out,
                  cudaStream_t stream) {
  // one level's (update, channel) pairs are counted in 32 bits
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_chan < 1 || n_per_level < 0 ||
      n_rows < 0 || n_per_level * n_chan >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  LevelStarts starts;
  for (int l = 0; l < n_levels; ++l) starts.v[l] = level_starts[l];
  if (n_per_level == 0 || n_rows == 0) return 0;
  // the vector kernels load V = min(C, 4) payload values and add V table
  // channels at once: both must be aligned to V values
  const int V = n_chan < 4 ? n_chan : 4;
  const bool vec = aligned(vals, V * sizeof(T)) && aligned(out, V * sizeof(float));
  if (vec && n_chan == 2)
    launch_rows<T, 2, ROUND>(idx, vals, starts, n_levels, n_per_level, n_rows, out, stream);
  else if (vec && n_chan == 4)
    launch_rows<T, 4, ROUND>(idx, vals, starts, n_levels, n_per_level, n_rows, out, stream);
  else if (vec && n_chan == 16)
    launch_rows<T, 16, ROUND>(idx, vals, starts, n_levels, n_per_level, n_rows, out, stream);
  else if (vec && n_chan == 32)
    launch_rows<T, 32, ROUND>(idx, vals, starts, n_levels, n_per_level, n_rows, out, stream);
  else {
    const int64_t n_pairs = n_per_level * n_chan;
    int64_t blocks = (n_pairs + THREADS - 1) / THREADS;
    if (blocks > 4096) blocks = 4096;  // grid-stride beyond that
    const dim3 grid((unsigned)blocks, (unsigned)n_levels);
    level_histogram_kernel<T, ROUND><<<grid, THREADS, 0, stream>>>(
        idx, vals, starts, out, n_per_level, n_chan, n_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" {

int level_histogram_f32(const void* idx, const void* vals, const int64_t* level_starts,
                        int n_levels, int64_t n_per_level, int n_chan, int64_t n_rows,
                        int round_bf16, void* out, void* stream) {
  if (round_bf16)
    return launch<float, true>((const int32_t*)idx, (const float*)vals, level_starts,
                               n_levels, n_per_level, n_chan, n_rows, (float*)out,
                               (cudaStream_t)stream);
  return launch<float, false>((const int32_t*)idx, (const float*)vals, level_starts,
                              n_levels, n_per_level, n_chan, n_rows, (float*)out,
                              (cudaStream_t)stream);
}

// a bf16 payload is rounded already: round_bf16 changes nothing
int level_histogram_bf16(const void* idx, const void* vals, const int64_t* level_starts,
                         int n_levels, int64_t n_per_level, int n_chan, int64_t n_rows,
                         int round_bf16, void* out, void* stream) {
  (void)round_bf16;
  return launch<__nv_bfloat16, false>((const int32_t*)idx, (const __nv_bfloat16*)vals,
                                      level_starts, n_levels, n_per_level, n_chan, n_rows,
                                      (float*)out, (cudaStream_t)stream);
}

}  // extern "C"
