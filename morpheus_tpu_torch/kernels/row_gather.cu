// Row gather of hash-grid table rows, level by level, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package gathers these rows with an XLA take
// in morpheus_tpu/ops/hashgrid.py (the row-gather routes: hist_rows,
// sort_pallas_rows, sort_pallas); the port first ran that take as
// index_select, whose kernel on this card reads a few percent of the bytes per
// second the card allows at these shapes. The function is an exact copy:
//
//   out[l * Np + i] = table[level_starts[l] + idx[l, i]]     (one row, R bytes)
//
// for any row of R = C * sizeof(element) bytes (f32 or bf16 tables alike: the
// kernel moves bytes and rounds nothing).
//
// What bounds it on this card: bytes. The (L * Np, C) output is written once
// and is the largest stream; the int32 indices are read once; the table is
// read once from device memory and then from L2 (it is 6.7 MB at 16 levels
// of 2^15 rows and C = 4 f32, inside the 50 MB L2). There is no arithmetic.
// So the design moves 16-byte units wherever the row allows:
//
// - one grid row (blockIdx.y) per level: a block sees one level start and
//   divides nothing to find it;
// - a row of R >= 16 bytes (16 B f32 C = 4, 128 B for the packed dense
//   prefix's C = 32, 64 B under bf16) is 2^s units of 16 bytes, one thread a
//   unit: the row's threads are neighbours in the warp, so the index read is
//   one broadcast and the row's load and store are one contiguous 16 B each;
// - 8-byte rows (bf16 with C = 4, f32 with C = 2) are paired: one thread
//   loads two consecutive rows of a level and writes them with one 16-byte
//   store (needs an even Np). Pairing takes 5-8% off the unpaired 8-byte
//   kernel at the real and SDS steps' tails (measured on an H100). An odd
//   Np, a 4-byte row (bf16 with C = 2) and a table view off a 16-byte
//   boundary take the unit kernel with the widest unit that divides the
//   row and both pointers' alignment;
// - the rows the port sends are 4 to 128 bytes, each a power of two; any
//   other width, or a pointer off a 4-byte boundary, is refused
//   (cudaErrorInvalidValue) rather than given a path no caller runs;
// - indices are read coalesced and streamed (__ldcs); each thread issues
//   UNROLL index loads, then UNROLL independent row loads (__ldg, the table
//   stays in L2), then UNROLL streaming stores (__stcs, so the output does not
//   push the table out of L2): several random reads in flight a thread cover
//   their latency.
//
// Every index is in range by construction: the encode takes each level's row
// modulo the level's size (ops/hashgrid.py _corner_rows) or from a packed
// prefix row of the level. So the kernel checks no bounds on the card; the
// plain version's index_select still raises on an index out of range.
//
// No synchronisation and no allocation: the caller allocates the output, and
// the launch goes on the caller's stream, so a CUDA graph captures it.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// and called through the plain C entry point below (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 64

constexpr int THREADS = 256;
constexpr int UNROLL = 4;   // units in flight per thread

struct LevelStarts {
  int64_t v[MAX_LEVELS];
};

// A row of 1 << shift units of type U (16, 8 or 4 bytes). Item k of a level
// is unit k % units of its row k >> shift.
template <typename U>
__global__ void __launch_bounds__(THREADS)
row_gather_units(const int32_t* __restrict__ idx, const U* __restrict__ table,
                 LevelStarts starts, U* __restrict__ out, int64_t n_per_level, int shift) {
  const int level = blockIdx.y;
  const int units = 1 << shift;
  const int64_t n_items = n_per_level << shift;
  const int32_t* lidx = idx + (int64_t)level * n_per_level;
  U* lout = out + (int64_t)level * n_items;
  const int64_t start = starts.v[level];
  const int64_t base = (int64_t)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;

  int64_t src[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t k = base + u * THREADS;
    if (k < n_items) {
      const int64_t i = k >> shift;
      src[u] = ((start + __ldcs(lidx + i)) << shift) + (k & (units - 1));
    }
  }
  U x[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (base + u * THREADS < n_items) x[u] = __ldg(table + src[u]);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t k = base + u * THREADS;
    if (k < n_items) __stcs(lout + k, x[u]);
  }
}

// Two 8-byte rows a thread, their indices read as one int2 and the rows
// written with one 16-byte store; Np is even, so a thread's rows lie in one
// level.
__global__ void __launch_bounds__(THREADS)
row_gather_pairs(const int32_t* __restrict__ idx, const uint2* __restrict__ table,
                 LevelStarts starts, uint4* __restrict__ out, int64_t n_per_level) {
  const int level = blockIdx.y;
  const int64_t n_items = n_per_level / 2;
  const int32_t* lidx = idx + (int64_t)level * n_per_level;
  uint4* lout = out + (int64_t)level * n_items;
  const int64_t start = starts.v[level];
  const int64_t base = (int64_t)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;

  int64_t row[UNROLL][2];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t k = base + u * THREADS;
    if (k < n_items) {
      const int2 i2 = __ldcs(reinterpret_cast<const int2*>(lidx) + k);
      row[u][0] = start + i2.x;
      row[u][1] = start + i2.y;
    }
  }
  uint2 a[UNROLL], b[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (base + u * THREADS < n_items) {
      a[u] = __ldg(table + row[u][0]);
      b[u] = __ldg(table + row[u][1]);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t k = base + u * THREADS;
    if (k < n_items) __stcs(lout + k, make_uint4(a[u].x, a[u].y, b[u].x, b[u].y));
  }
}

static bool aligned(const void* p, int64_t bytes) { return (uintptr_t)p % bytes == 0; }

static dim3 grid_for(int64_t n_items, int n_levels) {
  const int64_t blocks = (n_items + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  return dim3((unsigned)blocks, (unsigned)n_levels);
}

template <typename U>
static void launch_units(const int32_t* idx, const void* table, const LevelStarts& starts,
                         int n_levels, int64_t n_per_level, int64_t row_bytes, void* out,
                         cudaStream_t stream) {
  int shift = 0;
  while (((int64_t)sizeof(U) << shift) < row_bytes) ++shift;
  row_gather_units<U><<<grid_for(n_per_level << shift, n_levels), THREADS, 0, stream>>>(
      idx, (const U*)table, starts, (U*)out, n_per_level, shift);
}

extern "C" {

// idx (n_levels, n_per_level) int32, table (T, row_bytes / element) rows,
// out (n_levels * n_per_level) rows of row_bytes; returns a CUDA error code
// (cudaErrorInvalidValue for arguments out of range: a row that is not a
// power of two of 4 bytes or more, or a table or output off a 4-byte
// boundary).
int row_gather(const void* idx, const void* table, const int64_t* level_starts, int n_levels,
               int64_t n_per_level, int64_t row_bytes, void* out, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_per_level < 0 || row_bytes < 4 ||
      row_bytes > ((int64_t)1 << 20) || (row_bytes & (row_bytes - 1)) || !aligned(table, 4) ||
      !aligned(out, 4))
    return (int)cudaErrorInvalidValue;
  LevelStarts starts;
  for (int l = 0; l < n_levels; ++l) starts.v[l] = level_starts[l];
  if (n_per_level == 0) return 0;
  const int32_t* ix = (const int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  // 8-byte rows in pairs, one 16-byte store for two
  if (row_bytes == 8 && n_per_level % 2 == 0 && aligned(idx, 8) && aligned(table, 8) &&
      aligned(out, 16)) {
    row_gather_pairs<<<grid_for(n_per_level / 2, n_levels), THREADS, 0, s>>>(
        ix, (const uint2*)table, starts, (uint4*)out, n_per_level);
    return (int)cudaGetLastError();
  }
  // the widest unit of 16 bytes or less that divides the row and the
  // alignment of both pointers (4 bytes at least, checked above)
  int64_t unit = 16;
  while (unit > 4 && (row_bytes % unit || !aligned(table, unit) || !aligned(out, unit)))
    unit /= 2;
  if (unit == 16)
    launch_units<uint4>(ix, table, starts, n_levels, n_per_level, row_bytes, out, s);
  else if (unit == 8)
    launch_units<uint2>(ix, table, starts, n_levels, n_per_level, row_bytes, out, s);
  else
    launch_units<uint32_t>(ix, table, starts, n_levels, n_per_level, row_bytes, out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
