// Segment sum of a sorted (row, value) stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel morpheus_tpu/ops/segsum_pallas.py::segment_sum_sorted
// (kernel body _kernel, a windowed one-hot MXU matmul per 2048-update block,
// its grid walked in order on one core). Same function and precision contract,
// with the caller's permutation and rounding folded into the load:
//
//   out[keys[i], c] = sum over i of float(r(vals[order[i], c]))
//
// for nondecreasing keys; order is the identity when absent, r rounds an f32
// payload to bf16 (__float2bfloat16_rn, as .to(bfloat16) does) when round_bf16
// is set and is the identity otherwise; sums in f32. Every table row is written
// once, with zeros where no update lands, so the output needs no zero-fill. Keys
// outside [0, size) are dropped. The output is the (T, C) table layout itself.
// An unsorted stream gives a wrong sum: the sort stays with the caller.
//
// What bounds it on this card: one f32 add per (update, channel), so arithmetic
// is negligible; the bytes are the keys, the order and the payload read once and
// the table written once. The payload reads through `order` are random rows, but
// the hash-grid streams are level-major, so the rows one level's keys point at
// lie in that level's slab of the cotangent (5.2 MB at 327,680 f32 rows of C=4)
// and hit L2.
//
// Why the previous design was slow (on an H100, 0.046 ms on the 5.24M-row
// stream, 2.2x its bound, and 0.085 ms more for the route's permutation; see
// PERF.md): (1) the table was zero-filled by a separate launch and then added
// into; (2) its atomics landed in an order that changed between runs, so the
// result did not repeat bit for bit; (3) each channel was a scalar load; (4)
// the warp scan shuffled C scalars a step and each run landed as C scalar
// atomics; (5) a fixed chunk of 16 tiles a warp left most of the card idle on
// the step's small streams; (6) the caller cast the cotangent to bf16,
// permuted it with index_select and wrote it out before the kernel read it.
//
// The design: balanced ownership over the merged sequence (merge path). The N
// updates and the T table rows form one sequence of N + T items, update i before
// row r iff keys[i] <= r, cut into equal shares of 32 * items items, one share a
// warp. A share owns the rows r0 .. r1-1 whose row items it holds and the
// updates between; its updates have keys in [r0, r1] (and below 0 or past the
// table, dropped). Launch 1 runs the shares. A warp finds where its share starts
// and ends with two 16-way searches of the keys at once (a half-warp each). It
// takes its updates in chunks of 32 * ITEMS: coalesced lane-strided loads, all
// of a chunk in flight at once (the key, the order, and one 4/8/16-byte payload
// row read through `order`, rounded and widened in registers), turned through
// shared memory so that each lane holds ITEMS consecutive updates. A lane sums
// its runs of equal keys in order; the runs that cross lanes are joined by a
// segmented scan over the lanes (shuffles), and the run open at a chunk's end
// is carried into the next. A run lands with one plain vector store into its
// row, and a lane writes zeros into the rows between two keys that are not
// next to each other, so rows r0+1 .. r1-1 are written once, by this warp
// alone. Row r0 may also take updates from the shares before (a run that
// crosses a seam): the share leaves its own part of row r0 and its open tail
// (the run on row r1) in the scratch, and launch 2, one warp per share that
// owns a row, adds to it the open tails from the nearest share before it that
// owns a row (in the common case just the one before) in a fixed order and
// writes row r0 once; it is a programmatic dependent launch, so its launch
// latency overlaps launch 1's end and the kernel waits for launch 1. No
// zero-fill, no atomic and no read-modify-write of the table; every sum is
// taken in an order fixed by (N, T, C) and the card alone (the same bits on
// every call), and a stream that lands on one row is cut into shares like any
// other. A share holds at most MAX_ITEMS items a lane (MAX_ITEMS_ORDERED
// through `order`, whose random row reads want more warps in flight) and
// shrinks with the stream until the warps fill the card (WARPS_PER_SM on each
// SM), so the step's small streams do not leave SMs idle. Each group of CT =
// 4, 2 or 1 channels has its own shares; CT = 4 or 2 when C is a multiple of
// it and the pointers are aligned for the vector load, else 1 (the generic
// path).
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// and called through the plain C entry points below (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

constexpr int THREADS = 256;         // 8 warps a block, one share each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ITEMS = 32;        // merged items of a share per lane, at most,
constexpr int MAX_ITEMS_ORDERED = 16;  // and when the payload is read through order
constexpr int ITEMS = 8;             // consecutive updates a lane sums at once
constexpr int WARPS_PER_SM = 16;     // shares that fill the card once
constexpr int NO_KEY = -2147483647 - 1;

template <bool ROUND>
__device__ __forceinline__ float widen(float v) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// two bf16 of one 32-bit word, the lower address in the low half
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

// CT consecutive payload values as f32, one 4/8/16-byte load
template <bool ROUND, int CT>
__device__ __forceinline__ void load_row(const float* p, float (&v)[CT]) {
  if constexpr (CT == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (CT == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
#pragma unroll
  for (int c = 0; c < CT; ++c) v[c] = widen<ROUND>(v[c]);
}
template <bool ROUND, int CT>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[CT]) {
  if constexpr (CT == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    unpack_bf16x2(t.x, v[0], v[1]);
    unpack_bf16x2(t.y, v[2], v[3]);
  } else if constexpr (CT == 2) {
    unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(p)), v[0], v[1]);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// one row of CT f32, one 4/8/16-byte store
template <int CT>
__device__ __forceinline__ void store_row(float* p, const float (&v)[CT]) {
  if constexpr (CT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (CT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The updates before diagonals d0 and d1 of the merged sequence, for each the
// least i in [max(0, d - size), min(d, n)] with keys[i] >= d - i (min(d, n) if
// none): one half-warp a diagonal, probing 16 points a step.
__device__ __forceinline__ void merge_search(const int32_t* __restrict__ keys, int64_t d0,
                                             int64_t d1, int64_t n, int64_t size, int lane,
                                             int64_t& i0, int64_t& i1) {
  const int half = lane >> 4, q = lane & 15;
  const int64_t d = half ? d1 : d0;
  int64_t lo = d - size > 0 ? d - size : 0;
  int64_t hi = d < n ? d : n;
  while (__any_sync(FULL_MASK, lo < hi)) {
    const int64_t span = hi - lo;
    const int64_t p = lo + span * q / 16;            // probes in [lo, hi)
    const bool past = lo < hi && (int64_t)__ldg(keys + p) >= d - p;
    const unsigned hit = (__ballot_sync(FULL_MASK, past) >> (16 * half)) & 0xffffu;
    if (lo < hi) {
      if (hit == 0) {
        lo += span * 15 / 16 + 1;
      } else {
        const int k = __ffs(hit) - 1;
        hi = lo + span * k / 16;
        if (k > 0) lo += span * (k - 1) / 16 + 1;
      }
    }
  }
  i0 = __shfl_sync(FULL_MASK, lo, 0);
  i1 = __shfl_sync(FULL_MASK, lo, 16);
}

// The scratch of one call: per channel group and share, the share's own part
// of its first row and its open tail (CT f32 each), and its first row (-1 if
// it owns none).
struct Seams {
  float* head;             // groups * shares * CT
  float* tail;             // groups * shares * CT
  int* row;                // groups * shares
};

// Launch 2: the first row of each share that owns one, one warp a share: the
// share's own part plus what the shares before it carry in, the open tails
// from the nearest share before it that owns a row (or from the first share)
// up to the one before it. The tails are summed lane-strided in share order,
// then across the lanes in a fixed butterfly, so the sum depends on the shares
// alone; when the share before owns a row, it is that share's tail.
template <int CT>
__global__ void __launch_bounds__(THREADS)
segment_sum_seams_kernel(int64_t n_shares, int groups, int n_chan, Seams s,
                         float* __restrict__ out) {
  // a programmatic dependent launch: wait for launch 1 to finish and its
  // writes to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int64_t id = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (id >= n_shares * groups) return;       // warp-uniform
  const int64_t g = id / n_shares, b = id % n_shares, base = g * n_shares;
  const int row = __ldg(s.row + base + b);
  if (row < 0) return;
  float c[CT];
#pragma unroll
  for (int k = 0; k < CT; ++k) c[k] = 0.0f;
  if (b > 0 && __ldg(s.row + base + b - 1) >= 0) {
#pragma unroll
    for (int k = 0; k < CT; ++k) c[k] = __ldg(s.tail + (base + b - 1) * CT + k);
  } else if (b > 0) {
    int64_t a = 0;                   // the nearest owner before b - 1, else 0
    for (int64_t top = b - 2; top >= 0; top -= 32) {
      const int64_t idx = top - lane;
      const unsigned hit = __ballot_sync(FULL_MASK, idx >= 0 && __ldg(s.row + base + idx) >= 0);
      if (hit) {
        a = top - (__ffs(hit) - 1);
        break;
      }
    }
    for (int64_t idx = a + lane; idx < b; idx += 32) {
#pragma unroll
      for (int k = 0; k < CT; ++k) c[k] += __ldg(s.tail + (base + idx) * CT + k);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < CT; ++k) c[k] += __shfl_xor_sync(FULL_MASK, c[k], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < CT; ++k) c[k] += __ldg(s.head + (base + b) * CT + k);
    store_row<CT>(out + (int64_t)row * n_chan + g * CT, c);
  }
}

// Launch 1: one share of the merged sequence per warp.
template <typename T, int CT, bool ROUND, bool ORDERED>
__global__ void __launch_bounds__(THREADS)
segment_sum_sorted_kernel(const int32_t* __restrict__ keys, const T* __restrict__ vals,
                          const int64_t* __restrict__ order, int64_t n, int n_chan,
                          int size, int items, int64_t n_shares, int groups,
                          float* __restrict__ out, Seams s) {
  __shared__ float parts[WARPS][2][CT];    // each warp's first-row part, open tail
  // a chunk's keys and payload rows, turned from lane-strided to lane-
  // contiguous order; a padding slot every 128 bytes keeps the banks apart
  constexpr int PAD = 32 / CT;             // rows between padding slots
  __shared__ int skey[WARPS][32 * ITEMS + ITEMS];
  __shared__ __align__(16) float sval[WARPS][(32 * ITEMS + 32 * ITEMS / PAD) * CT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t id = (int64_t)blockIdx.x * WARPS + warp;
  if (id >= n_shares * groups) return;     // warp-uniform
  const int64_t g = id / n_shares, b = id % n_shares;
  const int c0 = (int)g * CT;
  const int share = 32 * items;
  const int64_t d0 = b * share;
  const int64_t d1 = d0 + share < n + size ? d0 + share : n + size;
  int64_t i0, i1;
  merge_search(keys, d0, d1, n, size, lane, i0, i1);
  const int n_upd = (int)(i1 - i0);
  const int r0 = (int)(d0 - i0);
  const int r1 = (int)(d1 - i0) - n_upd;
  const int last_key = n_upd > 0 ? __ldg(keys + i1 - 1) : r0;
  float* head = parts[warp][0];
  float* tail = parts[warp][1];
  if (lane < 2 * CT) (&parts[warp][0][0])[lane] = 0.0f;
  __syncwarp();

  const float zero[CT] = {};
  // a run of key k and sum v: its row, the share's part of row r0, its open
  // tail (the run on row r1), or dropped
  auto land = [&](int k, const float (&v)[CT]) {
    if (k > r0 && k < r1) {
      store_row<CT>(out + (int64_t)k * n_chan + c0, v);
    } else if (k == r0 && r0 < r1) {
#pragma unroll
      for (int c = 0; c < CT; ++c) head[c] = v[c];
    } else if (k == r1 && r1 < size) {
#pragma unroll
      for (int c = 0; c < CT; ++c) tail[c] = v[c];
    }
  };
  // zeros into the share's rows strictly between keys a and z
  auto zero_gap = [&](int a, int z) {
    if ((int64_t)z <= (int64_t)a + 1) return;
    const int lo = (a > r0 ? a : r0) + 1, hi = z < r1 ? z : r1;
    for (int r = lo; r < hi; ++r) store_row<CT>(out + (int64_t)r * n_chan + c0, zero);
  };

  // Chunks of 32 * ITEMS updates, ITEMS consecutive ones a lane, all loads of a
  // chunk in flight at once. A lane sums its runs in order; runs that cross
  // lanes are joined by a segmented scan over the lanes, and the run open at
  // the chunk's end is carried into the next.
  int carry_key = NO_KEY;            // the run open at the previous chunk's end
  float carry[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) carry[c] = 0.0f;
  int gap_key = r0;                  // the key before this chunk's first update
  for (int j0 = 0; j0 < n_upd; j0 += 32 * ITEMS) {
    // lane-strided loads (coalesced), all in flight at once
    int key[ITEMS];
    int64_t src[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int j = j0 + u * 32 + lane;
      key[u] = -1;                   // past the end: a dropped run
      src[u] = -1;
      if (j < n_upd) {
        key[u] = __ldg(keys + i0 + j);
        src[u] = ORDERED ? (int64_t)__ldg(reinterpret_cast<const long long*>(order) + i0 + j)
                         : i0 + j;
      }
    }
    float v[ITEMS][CT];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (src[u] >= 0) {
        load_row<ROUND, CT>(vals + src[u] * n_chan + c0, v[u]);
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c) v[u][c] = 0.0f;
      }
    }
    // to lane-contiguous: this lane's updates j0 + lane * ITEMS + u
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int r = u * 32 + lane;
      skey[warp][r + r / 32] = key[u];
      store_row<CT>(&sval[warp][(r + r / PAD) * CT], v[u]);
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int r = lane * ITEMS + u;
      key[u] = skey[warp][r + r / 32];
      const float* p = &sval[warp][(r + r / PAD) * CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) v[u][c] = p[c];
    }
    __syncwarp();
    // this lane's runs: the first (hk, hv) if more follow, the last (tk, tv)
    const int hk = key[0];
    int tk = key[0];
    float hv[CT], tv[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) hv[c] = tv[c] = v[0][c];
    bool multi = false;
#pragma unroll
    for (int u = 1; u < ITEMS; ++u) {
      if (key[u] == tk) {
#pragma unroll
        for (int c = 0; c < CT; ++c) tv[c] += v[u][c];
      } else {
        if (multi) {
          land(tk, tv);
        } else {
#pragma unroll
          for (int c = 0; c < CT; ++c) hv[c] = tv[c];
          multi = true;
        }
        zero_gap(tk, key[u]);
        tk = key[u];
#pragma unroll
        for (int c = 0; c < CT; ++c) tv[c] = v[u][c];
      }
    }
    // join the lanes: S = the open run's sum up to this lane's end, restarted
    // where a lane starts a new run
    int prev = __shfl_up_sync(FULL_MASK, tk, 1);
    const int next = __shfl_down_sync(FULL_MASK, hk, 1);
    if (lane == 0) {
      prev = carry_key;
      if (hk != carry_key) land(carry_key, carry);   // it ended with the chunk
    }
    zero_gap(lane == 0 ? gap_key : prev, hk);
    bool f = multi || hk != prev;
    float S[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) S[c] = tv[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool pf = __shfl_up_sync(FULL_MASK, (int)f, d);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float t = __shfl_up_sync(FULL_MASK, S[c], d);
        if (lane >= d && !f) S[c] = t + S[c];
      }
      if (lane >= d) f = f || pf;
    }
    if (!f) {                        // the run open at the previous chunk's end
#pragma unroll
      for (int c = 0; c < CT; ++c) S[c] = carry[c] + S[c];
    }
    float E[CT];                     // the same, up to the previous lane's end
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      E[c] = __shfl_up_sync(FULL_MASK, S[c], 1);
      if (lane == 0) E[c] = carry[c];
    }
    if (multi) {                     // the first run ends in this lane
      if (hk == prev) {
#pragma unroll
        for (int c = 0; c < CT; ++c) hv[c] = E[c] + hv[c];
      }
      land(hk, hv);
    }
    if (lane < 31 && next != tk) land(tk, S);
    carry_key = __shfl_sync(FULL_MASK, tk, 31);
#pragma unroll
    for (int c = 0; c < CT; ++c) carry[c] = __shfl_sync(FULL_MASK, S[c], 31);
    gap_key = carry_key;
  }
  if (lane == 0) land(carry_key, carry);
  // zeros after the last key, up to the share's last row
  const int lo = (last_key > r0 ? last_key : r0) + 1;
  for (int r = lo + lane; r < r1; r += 32) store_row<CT>(out + (int64_t)r * n_chan + c0, zero);
  __syncwarp();

  // the share's part of its first row, its open tail, and the row (launch 2)
  if (lane == 0) {
    const int64_t sid = g * n_shares + b;
    float t[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) t[c] = head[c];
    store_row<CT>(s.head + sid * CT, t);
#pragma unroll
    for (int c = 0; c < CT; ++c) t[c] = tail[c];
    store_row<CT>(s.tail + sid * CT, t);
    s.row[sid] = r0 < r1 ? r0 : -1;
  }
}

struct Plan {
  int items;
  int64_t shares;
};

static Plan plan(int64_t n, int64_t size, bool ordered) {
  static int sms = 0;                // one card per process
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t total = n + size;
  const int64_t fill = (int64_t)sms * WARPS_PER_SM * 32;   // lanes that fill it once
  const int64_t most = ordered ? MAX_ITEMS_ORDERED : MAX_ITEMS;
  int64_t items = (total + fill - 1) / fill;
  items = items < 1 ? 1 : items > most ? most : items;
  return {(int)items, (total + 32 * items - 1) / (32 * items)};
}

// scratch: per channel group and share the first-row part and open tail (CT
// f32 each) and the first row (int)
static int64_t scratch_bytes(int64_t shares, int n_chan) {
  return shares * (int64_t)n_chan * 4 * 3;
}

static bool aligned(const void* p, size_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

template <typename T, int CT, bool ROUND, bool ORDERED>
static int run(const int32_t* keys, const T* vals, const int64_t* order, int64_t n,
               int n_chan, int size, float* out, void* scratch, cudaStream_t stream) {
  const Plan p = plan(n, size, ORDERED);
  const int groups = n_chan / CT;
  Seams s;
  s.head = (float*)scratch;
  s.tail = s.head + p.shares * n_chan;
  s.row = (int*)(s.tail + p.shares * n_chan);
  const int64_t n_states = p.shares * groups;
  const int64_t blocks = (n_states + WARPS - 1) / WARPS;
  segment_sum_sorted_kernel<T, CT, ROUND, ORDERED><<<(unsigned)blocks, THREADS, 0, stream>>>(
      keys, vals, order, n, n_chan, size, p.items, p.shares, groups, out, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // launch 2's launch latency overlaps launch 1; the kernel waits for it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, segment_sum_seams_kernel<CT>, p.shares, groups, n_chan,
                                 s, out);
}

template <typename T, int CT, bool ROUND>
static int run_ct(const int32_t* keys, const T* vals, const int64_t* order, int64_t n,
                  int n_chan, int size, float* out, void* scratch, cudaStream_t stream) {
  if (order)
    return run<T, CT, ROUND, true>(keys, vals, order, n, n_chan, size, out, scratch, stream);
  return run<T, CT, ROUND, false>(keys, vals, order, n, n_chan, size, out, scratch, stream);
}

template <typename T, bool ROUND>
static int launch(const int32_t* keys, const T* vals, const int64_t* order, int64_t n,
                  int n_chan, int64_t size, float* out, void* scratch, cudaStream_t stream) {
  // rows and share-local positions are counted in 32 bits, shares in 32 unsigned
  if (n < 0 || n_chan < 1 || n_chan > 65535 || size < 0 ||
      size > ((int64_t)1 << 31) - 1 - 32 * MAX_ITEMS)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || size == 0) return 0;
  if (plan(n, size, true).shares * n_chan >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const int s = (int)size;
  if (n_chan % 4 == 0 && aligned(vals, 4 * sizeof(T)) && aligned(out, 16))
    return run_ct<T, 4, ROUND>(keys, vals, order, n, n_chan, s, out, scratch, stream);
  if (n_chan % 2 == 0 && aligned(vals, 2 * sizeof(T)) && aligned(out, 8))
    return run_ct<T, 2, ROUND>(keys, vals, order, n, n_chan, s, out, scratch, stream);
  return run_ct<T, 1, ROUND>(keys, vals, order, n, n_chan, s, out, scratch, stream);
}

extern "C" {

// bytes of the scratch buffer a call needs
int64_t segment_sum_sorted_scratch_bytes(int64_t n, int n_chan, int64_t size) {
  if (n <= 0 || size <= 0 || n_chan < 1) return 0;
  return scratch_bytes(plan(n, size, true).shares, n_chan);   // the most shares
}

int segment_sum_sorted_f32(const void* keys, const void* vals, const void* order, int64_t n,
                           int n_chan, int64_t size, int round_bf16, void* out, void* scratch,
                           void* stream) {
  if (round_bf16)
    return launch<float, true>((const int32_t*)keys, (const float*)vals,
                               (const int64_t*)order, n, n_chan, size, (float*)out, scratch,
                               (cudaStream_t)stream);
  return launch<float, false>((const int32_t*)keys, (const float*)vals,
                              (const int64_t*)order, n, n_chan, size, (float*)out, scratch,
                              (cudaStream_t)stream);
}

// a bf16 payload is rounded already: round_bf16 changes nothing
int segment_sum_sorted_bf16(const void* keys, const void* vals, const void* order, int64_t n,
                            int n_chan, int64_t size, int round_bf16, void* out,
                            void* scratch, void* stream) {
  (void)round_bf16;
  return launch<__nv_bfloat16, false>((const int32_t*)keys, (const __nv_bfloat16*)vals,
                                      (const int64_t*)order, n, n_chan, size, (float*)out,
                                      scratch, (cudaStream_t)stream);
}

}  // extern "C"
