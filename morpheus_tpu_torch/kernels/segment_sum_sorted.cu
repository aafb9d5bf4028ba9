// Segment sum of a sorted (row, value) stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel morpheus_tpu/ops/segsum_pallas.py::segment_sum_sorted
// (kernel body _kernel, a windowed one-hot MXU matmul per 2048-update block).
// Same function and precision contract:
//
//   out[idx[i], c] += float(vals[i, c])      for a nondecreasing idx
//
// accumulated in f32; bf16 payloads are rounded once by the caller and widened
// here on the way in. The output is the (T, C) table layout itself.
//
// What bounds it on this card: one f32 add per (update, channel), so
// arithmetic is negligible; the bytes are the key and payload streams read once
// and the table written once. What the sorted order buys is that equal keys sit
// next to each other, so each run can be summed in registers and land with one
// atomic instead of one per update. Each warp walks its own contiguous chunk of
// the stream 32 updates at a time: a segmented inclusive scan over the run
// heads (warp shuffles) sums every run of equal keys within the tile, the last
// lane of each run adds the run's sum to the table with one atomicAdd, and the
// tile's last run is carried in registers into the next tile, so a run that
// spans tiles costs one atomic per warp chunk. Only fragments split by a warp
// chunk's seam meet at one address. Each grid row (blockIdx.y) takes a group of
// CT channels. The result is right for any order of the stream (every fragment
// lands with an atomic); only the atomic count depends on the sort. Keys outside
// [0, size) are dropped.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// and called through the plain C entry points below (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

constexpr int TILES_PER_WARP = 16;   // 32-update tiles in one warp's chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int CT>
__device__ __forceinline__ void land(float* out, int key, int64_t size, int n_chan,
                                     int c0, const float (&v)[CT]) {
  if (key < 0 || key >= size) return;
  float* row = out + (int64_t)key * n_chan + c0;
#pragma unroll
  for (int c = 0; c < CT; ++c) atomicAdd(row + c, v[c]);
}

template <typename T, int CT>
__global__ void __launch_bounds__(THREADS)
segment_sum_sorted_kernel(const int32_t* __restrict__ idx, const T* __restrict__ vals,
                          float* __restrict__ out, int64_t n, int n_chan, int64_t size) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t begin = warp * (32 * TILES_PER_WARP);
  if (begin >= n) return;                       // warp-uniform
  const int64_t end = begin + 32 * TILES_PER_WARP < n ? begin + 32 * TILES_PER_WARP : n;
  const int c0 = blockIdx.y * CT;

  int carry_key = -1;                           // the previous tile's last run
  float carry[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) carry[c] = 0.0f;

  for (int64_t base = begin; base < end; base += 32) {
    const int64_t i = base + lane;
    const bool valid = i < end;
    const int key = valid ? idx[i] : -1;        // lanes past the end: a dropped run
    float v[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) v[c] = valid ? widen(vals[i * n_chan + c0 + c]) : 0.0f;

    const int prev = __shfl_up_sync(FULL_MASK, key, 1);
    const int next = __shfl_down_sync(FULL_MASK, key, 1);
    const bool tail = lane == 31 || next != key;
    const unsigned heads = __ballot_sync(FULL_MASK, lane == 0 || prev != key);
    // first lane of this lane's run: the highest run head at or below it
    const int start = 31 - __clz(heads & (FULL_MASK >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float t = __shfl_up_sync(FULL_MASK, v[c], d);
        if (lane - d >= start) v[c] += t;
      }
    }

    // the carried run either continues into this tile's first run or is done
    const int first = __shfl_sync(FULL_MASK, key, 0);
    if (first == carry_key) {
      if (start == 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) v[c] += carry[c];
      }
    } else if (lane == 0) {
      land<CT>(out, carry_key, size, n_chan, c0, carry);
    }
    if (tail && lane != 31) land<CT>(out, key, size, n_chan, c0, v);
    carry_key = __shfl_sync(FULL_MASK, key, 31);
#pragma unroll
    for (int c = 0; c < CT; ++c) carry[c] = __shfl_sync(FULL_MASK, v[c], 31);
  }
  if (lane == 0) land<CT>(out, carry_key, size, n_chan, c0, carry);
}

template <typename T, int CT>
static int launch_ct(const int32_t* idx, const T* vals, int64_t n, int n_chan, int64_t size,
                     float* out, cudaStream_t stream) {
  const int64_t per_warp = 32 * TILES_PER_WARP;
  const int64_t warps = (n + per_warp - 1) / per_warp;
  const int64_t blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  const dim3 grid((unsigned)blocks, (unsigned)(n_chan / CT));
  segment_sum_sorted_kernel<T, CT><<<grid, THREADS, 0, stream>>>(idx, vals, out, n, n_chan,
                                                                 size);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const int32_t* idx, const T* vals, int64_t n, int n_chan, int64_t size,
                  float* out, cudaStream_t stream) {
  if (n < 0 || n_chan < 1 || n_chan > 65535 || size < 0 ||
      (n + 32 * TILES_PER_WARP) / (32 * TILES_PER_WARP) * (THREADS / 32) >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || size == 0) return 0;
  if (n_chan % 4 == 0) return launch_ct<T, 4>(idx, vals, n, n_chan, size, out, stream);
  if (n_chan % 2 == 0) return launch_ct<T, 2>(idx, vals, n, n_chan, size, out, stream);
  return launch_ct<T, 1>(idx, vals, n, n_chan, size, out, stream);
}

extern "C" {

int segment_sum_sorted_f32(const void* idx, const void* vals, int64_t n, int n_chan,
                           int64_t size, void* out, void* stream) {
  return launch<float>((const int32_t*)idx, (const float*)vals, n, n_chan, size, (float*)out,
                       (cudaStream_t)stream);
}

int segment_sum_sorted_bf16(const void* idx, const void* vals, int64_t n, int n_chan,
                            int64_t size, void* out, void* stream) {
  return launch<__nv_bfloat16>((const int32_t*)idx, (const __nv_bfloat16*)vals, n, n_chan,
                               size, (float*)out, (cudaStream_t)stream);
}

}  // extern "C"
