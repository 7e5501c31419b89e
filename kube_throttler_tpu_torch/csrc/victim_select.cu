// Greedy ranked-prefix victim selection: one block walks the ranked
// candidate rows in order.
//
// Replaces: kube_throttler_tpu/ops/victim_select.py::victim_select (an XLA
// lax.scan in the JAX package, not a Pallas kernel). The same recurrence,
// with remaining = deficit at the start:
//   helps    = any_j contrib[i,j] > 0 && remaining[j] > 0
//   take     = helps && (cap <= 0 || count < cap)
//   if take: remaining -= contrib[i,:]; count += 1
//   selected[i] = take;  ok = all_j remaining[j] <= 0
// Exact int64 throughout (Hopper compares and subtracts s64 natively).
//
// What bounds it: neither bytes nor operations, but the N sequential steps.
// Whether row i is taken depends on every earlier take, so each row costs
// one block-wide barrier (__syncthreads_or) and the latency of its load.
// The bytes (each contrib row read once) are small beside that.
//
// What the design does about it:
// - One block of up to 1024 threads; thread t owns columns t, t + B, ...,
//   so remaining[j] is only ever read and written by its owner thread and
//   the one barrier per row is the block-wide OR of "helps".
// - remaining lives in shared memory when M int64 fit there (any M up to
//   the 227 KB a block may use), else in the output buffer in device
//   memory; the code is the same behind a generic pointer.
// - The next row's first column per thread is loaded before the current
//   row's barrier, so its latency overlaps the barrier.
// - It stops early once the cap is reached or every remaining <= 0 (checked
//   with a second barrier only after a take), and writes false for the
//   rest, which is what the scan gives: no later row can be taken.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024) victim_select_kernel(
    const int64_t* __restrict__ contrib,  // [N,M] ranked candidate rows
    const int64_t* __restrict__ deficit,  // [M]
    uint8_t* __restrict__ selected,       // [N]
    uint8_t* __restrict__ ok,             // [1]
    int64_t* __restrict__ remaining_out,  // [M]
    int N, int M, int cap, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* rem = use_smem ? reinterpret_cast<int64_t*>(smem) : remaining_out;
  const int tid = threadIdx.x;
  const int B = blockDim.x;

  bool any_pos = false;
  for (int j = tid; j < M; j += B) {
    const int64_t d = deficit[j];
    rem[j] = d;
    any_pos |= d > 0;
  }
  bool live = __syncthreads_or(any_pos) != 0;  // some deficit still open

  int count = 0;
  int i = 0;
  int64_t nxt = (N > 0 && tid < M) ? __ldg(reinterpret_cast<const long long*>(contrib) + tid) : 0;
  for (; live && i < N; ++i) {
    const int64_t* row = contrib + static_cast<int64_t>(i) * M;
    const int64_t cur = nxt;
    if (i + 1 < N && tid < M) {
      nxt = __ldg(reinterpret_cast<const long long*>(row + M) + tid);
    }
    bool helps = tid < M && cur > 0 && rem[tid] > 0;
    for (int j = tid + B; j < M; j += B) helps |= row[j] > 0 && rem[j] > 0;
    const bool take = __syncthreads_or(helps) != 0 && (cap <= 0 || count < cap);
    if (tid == 0) selected[i] = take;
    if (take) {
      bool pos = false;
      if (tid < M) {
        rem[tid] -= cur;
        pos = rem[tid] > 0;
      }
      for (int j = tid + B; j < M; j += B) {
        rem[j] -= row[j];
        pos |= rem[j] > 0;
      }
      ++count;
      live = __syncthreads_or(pos) != 0 && (cap <= 0 || count < cap);
    }
  }
  for (int k = i + tid; k < N; k += B) selected[k] = 0;

  bool pos = false;
  for (int j = tid; j < M; j += B) {
    pos |= rem[j] > 0;
    if (use_smem) remaining_out[j] = rem[j];
  }
  const bool open = __syncthreads_or(pos) != 0;
  if (tid == 0) ok[0] = !open;
}

}  // namespace

// Plain C entry point for ctypes. ``threads`` and ``smem`` (bytes of
// dynamic shared memory: M * 8 when remaining lives there, else 0) come
// from the wrapper (ops/victim_select.py::_launch_shape). Returns the
// cudaError_t of the launch (0 = cudaSuccess); the kernel runs
// asynchronously on ``stream``.
extern "C" int kt_victim_select(const int64_t* contrib, const int64_t* deficit,
                                uint8_t* selected, uint8_t* ok, int64_t* remaining,
                                int N, int M, int cap, int threads, int smem,
                                void* stream) {
  const int use_smem = smem > 0;
  if (N < 0 || M < 1 || threads < 1 || threads > 1024 ||
      (use_smem && static_cast<int64_t>(smem) < static_cast<int64_t>(M) * 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        victim_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  victim_select_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      contrib, deficit, selected, ok, remaining, N, M, cap, use_smem);
  return static_cast<int>(cudaGetLastError());
}
