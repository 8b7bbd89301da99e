// Batched device-to-device copy: a list of (src, dst, nbytes) entries in one
// launch.  The graph route's store of a segment's outputs into the bank's
// persistent buffers (core/segments.py `_store`, ops/bank_copy.py).
//
// Replaces no TPU kernel.  On the TPU a segment's outputs are the jitted
// function's results and XLA places them; the port's graph route copies
// each output leaf into its buffer, and a captured `copy_` is one memcpy
// node of ~1.2-1.5 us on an H100 however few bytes it moves (a B = 1 solve
// of the constrained Rosenbrock family made ~1,060 of them, PERF.md).  Here
// a whole store is one node (two where aliased sources must be staged).
//
// What bounds it.  The bytes: each source read once, each destination
// written once.  A store at B = 1 or at a rescue's B moves at most tens of
// KB, so its time is one launch and one round trip to memory; a store at
// B = 16,384 moves a few MB, which the grid path spreads over the card.
//
// The descriptor is passed by value as the kernel's parameter (`Table`,
// under the 4 KB parameter space): a captured node bakes the pointers in,
// and no table lives in device memory, so nothing is copied from the host
// inside a capture.  At most kCap entries a launch; the wrapper splits a
// longer store.  Each entry is copied in units of 16, 8, 4, 2 or 1 bytes,
// the largest that divides both pointers and its size.  Every block first
// copies the table into shared memory, where each thread finds the entry of
// its unit by a binary search over the entries' first units.
//
// Two paths, chosen by the wrapper:
// * one block: every unit is loaded into shared memory, one barrier, then
//   every destination is written.  A source that shares memory with a
//   destination of the same launch therefore gives its value from before
//   the launch, with no clone.  It takes stores of up to kStageBytes.
// * grid: units spread over up to kMaxBlocks blocks, each copied straight
//   from source to destination.  No source may share memory with a
//   destination of the launch: the wrapper stages such sources first, in
//   a grid launch of their own into a scratch buffer.
//
// A copy is a bit copy: no arithmetic, nothing rounded.

#include <cuda_runtime.h>

namespace {

constexpr int kCap = 128;                // entries a launch
constexpr int kStageBytes = 40 * 1024;   // the one-block path's dynamic shared memory (+ the table < 48 KB)
constexpr int kGridThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Table {
  const char* src[kCap];
  char* dst[kCap];
  unsigned int start[kCap + 1];  // each entry's first unit; start[n] = the launch's units
  unsigned int off[kCap];        // each entry's byte offset in shared memory (one-block path)
  unsigned char lg[kCap];        // log2 of each entry's unit in bytes
  int n;
};
static_assert(sizeof(Table) <= 4096, "the table must fit the kernel parameter space");

struct Local {
  const char* src[kCap];
  char* dst[kCap];
  unsigned int start[kCap + 1];
  unsigned int off[kCap];
  unsigned char lg[kCap];
};

__device__ __forceinline__ void to_shared(const Table& t, Local& s) {
  for (int k = threadIdx.x; k <= t.n; k += blockDim.x) {
    s.start[k] = t.start[k];
    if (k < t.n) {
      s.src[k] = t.src[k];
      s.dst[k] = t.dst[k];
      s.off[k] = t.off[k];
      s.lg[k] = t.lg[k];
    }
  }
  __syncthreads();
}

// the entry of unit u: the last k with start[k] <= u (entries of no units
// share their start with the next entry and are never found)
__device__ __forceinline__ int find(const Local& s, int n, unsigned int u) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (s.start[mid] <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void copy_unit(const char* from, char* to, int lg) {
  switch (lg) {
    case 4: *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from); break;
    case 3: *reinterpret_cast<uint2*>(to) = *reinterpret_cast<const uint2*>(from); break;
    case 2: *reinterpret_cast<unsigned int*>(to) = *reinterpret_cast<const unsigned int*>(from); break;
    case 1: *reinterpret_cast<unsigned short*>(to) = *reinterpret_cast<const unsigned short*>(from); break;
    default: *to = *from;
  }
}

__global__ void __launch_bounds__(1024) bank_copy_one_block(const __grid_constant__ Table t) {
  extern __shared__ uint4 stage[];
  __shared__ Local s;
  to_shared(t, s);
  const int n = t.n;
  const unsigned int units = s.start[n];
  char* buf = reinterpret_cast<char*>(stage);
  for (unsigned int u = threadIdx.x; u < units; u += blockDim.x) {
    const int k = find(s, n, u);
    const int lg = s.lg[k];
    const size_t b = static_cast<size_t>(u - s.start[k]) << lg;
    copy_unit(s.src[k] + b, buf + s.off[k] + b, lg);
  }
  __syncthreads();  // every source read before any destination is written
  for (unsigned int u = threadIdx.x; u < units; u += blockDim.x) {
    const int k = find(s, n, u);
    const int lg = s.lg[k];
    const size_t b = static_cast<size_t>(u - s.start[k]) << lg;
    copy_unit(buf + s.off[k] + b, s.dst[k] + b, lg);
  }
}

__global__ void __launch_bounds__(kGridThreads) bank_copy_grid(const __grid_constant__ Table t) {
  __shared__ Local s;
  to_shared(t, s);
  const int n = t.n;
  const unsigned int units = s.start[n];
  const unsigned int step = gridDim.x * blockDim.x;
  for (unsigned int u = blockIdx.x * blockDim.x + threadIdx.x; u < units; u += step) {
    const int k = find(s, n, u);
    const int lg = s.lg[k];
    const size_t b = static_cast<size_t>(u - s.start[k]) << lg;
    copy_unit(s.src[k] + b, s.dst[k] + b, lg);
  }
}

}  // namespace

extern "C" {

// entries: n rows of (src, dst, nbytes) as 64-bit integers.  Returns
// cudaGetLastError() after the launch (0 and no launch when there is no
// byte to copy), -1 for n outside 1..kCap, -2 for a launch of 2^31 units or
// more, -3 for a one-block launch above kStageBytes.
int cannoles_bank_copy(const long long* entries, int n, int one_block, void* stream) {
  if (n < 1 || n > kCap) return -1;
  Table t;
  t.n = n;
  unsigned long long units = 0, smem = 0;
  for (int k = 0; k < n; ++k) {
    const unsigned long long src = entries[3 * k], dst = entries[3 * k + 1], nb = entries[3 * k + 2];
    int lg = 4;
    while (lg > 0 && ((src | dst | nb) & ((1ull << lg) - 1))) --lg;
    t.src[k] = reinterpret_cast<const char*>(src);
    t.dst[k] = reinterpret_cast<char*>(dst);
    t.start[k] = static_cast<unsigned int>(units);
    t.off[k] = static_cast<unsigned int>(smem);
    t.lg[k] = static_cast<unsigned char>(lg);
    units += nb >> lg;
    smem += (nb + 15) & ~15ull;
    if (units >= (1ull << 31)) return -2;
  }
  t.start[n] = static_cast<unsigned int>(units);
  if (units == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (one_block) {
    if (smem > static_cast<unsigned long long>(kStageBytes)) return -3;
    const int threads = units >= 1024 ? 1024 : static_cast<int>((units + 31) / 32 * 32);
    bank_copy_one_block<<<1, threads, static_cast<size_t>(smem), s>>>(t);
  } else {
    const unsigned long long want = (units + kGridThreads - 1) / kGridThreads;
    const int blocks = want < kMaxBlocks ? static_cast<int>(want) : kMaxBlocks;
    bank_copy_grid<<<blocks, kGridThreads, 0, s>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

int cannoles_bank_copy_cap(void) { return kCap; }

int cannoles_bank_copy_stage_bytes(void) { return kStageBytes; }

}  // extern "C"
