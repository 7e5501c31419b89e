// Sparse gather admission check: for each pod, the ordered 4-step check
// against the K throttle rows its matched cols name, reduced to per-pod
// class counts or written as per-slot statuses.
//
// Replaces: kube_throttler_tpu/ops/check.py::_gather_statuses with
// _gather_statuses_blocked and statuses_to_compact (XLA in the JAX
// package, not Pallas), behind check_pods_gather (counts) and
// check_pods_gather_statuses (statuses).
//
// Semantics (ops/check.py::_classify_core over the gathered rows, the plain
// version), with c = min(max(col, 0), T - 1), au = used + res (wrapping
// int64), au_p = used_p | res_p, nz(r) = pod present(r) && pod req(r) != 0:
//   exceeds = thr_cnt_p && thr_cnt < 1 || any_r nz && thr_p && req > thr
//   active  = st_cnt || thr_cnt_p && au_cnt_p && au_cnt >(=) thr_cnt
//             || any_r nz && (st_flag_p && st_req || thr_p && au_p && au >(=) thr)
//   over    = thr_cnt_p && au_cnt + 1 >(=) thr_cnt
//             || any_r nz && thr_p && au + req >(=) thr
//   slot    = col >= 0 && valid[c] && pod valid[p]
//   status  = !slot ? -1 : exceeds ? 3 : active ? 1 : over ? 2 : 0
// The step-3 compares are ">=" when STEP3_ON_EQUAL, the step-4 ones ">="
// when ON_EQUAL, else ">". Every dim term needs nz, and tot_p = au_p |
// pod_p holds wherever nz does. Sums wrap as two's complement, as torch
// and XLA add int64 (signed overflow is undefined in C++, so the adds go
// through uint64_t); compares are signed. No float appears.
// The counts form writes counts[p] = (#0, #1, #2, #3) over the pod's slots
// and schedulable[p] = #1 + #2 + #3 == 0; the statuses form writes the int8
// status of every slot. Both variant flags and the form are template
// parameters (8 kernels); the kernel reads the ThrottleState planes as they
// are, so the wrapper enqueues nothing but the outputs' allocation and this
// launch.
//
// What bounds it: bytes, by the count that chip_smoke.py computes from the
// run's data: cols read once, the pod planes read once, each throttle row
// that the cols name read once, the outputs written once; 0.0093 ms at the
// main path's tick state (131072 x 32 x 8). The rows that the cols name
// are read again by every pod that matches them; they live in L2.
//
// What the design does about it, simply (a first kernel that is right):
// - One warp per pod, its lanes striding over the pod's K slots, so every
//   K of the ladder (4 to 2048) takes the same code. A warp's col loads and
//   status stores are consecutive along K.
// - Each lane clamps its col, gathers the row's count side and its R dims,
//   and resolves the four steps in registers: no [P,K,R] tensor exists.
// - A dim where the pod requests nothing is skipped. The pod row is the
//   warp's own, so the branch is uniform across the warp.
// - The per-pod class counts are a __ballot_sync per class and __popc;
//   lane 0 writes the int32[4] and the schedulable gate.
// - Blocks of 256 threads hold 8 pods; the grid is ceil(P / 8) blocks on
//   grid.x (ops/check_gather.py::_launch_shape), so any P < 2^31 launches.
// Left for later: staging pod rows in shared memory, several pods per warp
// at small K (at K = 4 three quarters of the lanes idle).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // ops/check_gather.py::_THREADS

struct State {  // ThrottleState's planes, in its field order
  const uint8_t* __restrict__ valid;                // [T]
  const int64_t* __restrict__ thr_cnt;              // [T]
  const uint8_t* __restrict__ thr_cnt_present;      // [T]
  const int64_t* __restrict__ thr_req;              // [T,R]
  const uint8_t* __restrict__ thr_req_present;      // [T,R]
  const int64_t* __restrict__ used_cnt;             // [T]
  const uint8_t* __restrict__ used_cnt_present;     // [T]
  const int64_t* __restrict__ used_req;             // [T,R]
  const uint8_t* __restrict__ used_req_present;     // [T,R]
  const int64_t* __restrict__ res_cnt;              // [T]
  const uint8_t* __restrict__ res_cnt_present;      // [T]
  const int64_t* __restrict__ res_req;              // [T,R]
  const uint8_t* __restrict__ res_req_present;      // [T,R]
  const uint8_t* __restrict__ st_cnt_throttled;     // [T]
  const uint8_t* __restrict__ st_req_throttled;     // [T,R]
  const uint8_t* __restrict__ st_req_flag_present;  // [T,R]
};

struct Pods {  // PodBatch's planes and the matched cols
  const uint8_t* __restrict__ valid;    // [P]
  const int64_t* __restrict__ req;      // [P,R]
  const uint8_t* __restrict__ present;  // [P,R]
  const int32_t* __restrict__ cols;     // [P,K], -1 pads
};

struct Out {  // the form's outputs; the other form's pointers are null
  int8_t* __restrict__ statuses;      // [P,K]
  int32_t* __restrict__ counts;       // [P,4]
  uint8_t* __restrict__ schedulable;  // [P]
};

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

__device__ __forceinline__ bool ld1(const uint8_t* p) { return __ldg(p) != 0; }

// a + b with two's-complement wrap, as torch and XLA add int64
__device__ __forceinline__ int64_t wrap_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}

template <bool ON_EQUAL>
__device__ __forceinline__ bool cmp(int64_t u, int64_t t) {
  return ON_EQUAL ? u >= t : u > t;
}

// Status of pod row (req, present) against throttle row c (valid, in
// range). Within a warp every lane holds the same pod, so the skip of a
// dim the pod does not request is uniform.
template <bool ON_EQUAL, bool STEP3_ON_EQUAL>
__device__ __forceinline__ int8_t classify(const State& s, const int64_t* req,
                                           const uint8_t* present, int64_t c, int R) {
  const bool thr_cnt_p = ld1(s.thr_cnt_present + c);
  const int64_t thr_cnt = ld64(s.thr_cnt + c);
  const int64_t au_cnt = wrap_add(ld64(s.used_cnt + c), ld64(s.res_cnt + c));
  const bool au_cnt_p = ld1(s.used_cnt_present + c) | ld1(s.res_cnt_present + c);
  bool exceeds = thr_cnt_p & (thr_cnt < 1);
  bool active = ld1(s.st_cnt_throttled + c) |
                (thr_cnt_p & au_cnt_p & cmp<STEP3_ON_EQUAL>(au_cnt, thr_cnt));
  bool over = thr_cnt_p & cmp<ON_EQUAL>(wrap_add(au_cnt, 1), thr_cnt);
  const int64_t row = c * R;
  for (int r = 0; r < R; ++r) {
    const int64_t v = ld64(req + r);
    if (!ld1(present + r) || v == 0) continue;
    const int64_t g = row + r;
    const bool thr_p = ld1(s.thr_req_present + g);
    const int64_t thr = ld64(s.thr_req + g);
    const int64_t au = wrap_add(ld64(s.used_req + g), ld64(s.res_req + g));
    const bool au_p = ld1(s.used_req_present + g) | ld1(s.res_req_present + g);
    exceeds |= thr_p & (v > thr);
    active |= ld1(s.st_req_flag_present + g) & ld1(s.st_req_throttled + g);
    active |= thr_p & au_p & cmp<STEP3_ON_EQUAL>(au, thr);
    over |= thr_p & cmp<ON_EQUAL>(wrap_add(au, v), thr);
  }
  return exceeds ? 3 : active ? 1 : over ? 2 : 0;
}

template <bool ON_EQUAL, bool STEP3_ON_EQUAL, bool STATUSES>
__global__ void __launch_bounds__(kThreads) check_gather_kernel(State s, Pods pods, Out out,
                                                                int P, int K, int T, int R) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (p >= P) return;  // the whole warp: p is the warp's
  const bool pod_ok = ld1(pods.valid + p);
  const int64_t* req = pods.req + p * R;
  const uint8_t* present = pods.present + p * R;
  const int32_t* cols = pods.cols + p * K;
  uint32_t n[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += kWarp) {  // uniform trip count: every lane ballots
    const int k = k0 + lane;
    int8_t st = -1;
    if (k < K) {
      const int col = __ldg(cols + k);
      if (col >= 0 && pod_ok) {
        const int64_t c = col < T ? col : T - 1;
        if (ld1(s.valid + c)) st = classify<ON_EQUAL, STEP3_ON_EQUAL>(s, req, present, c, R);
      }
      if (STATUSES) out.statuses[p * K + k] = st;
    }
    if (!STATUSES) {
#pragma unroll
      for (int cls = 0; cls < 4; ++cls) n[cls] += __popc(__ballot_sync(0xffffffffu, st == cls));
    }
  }
  if (!STATUSES && lane == 0) {
#pragma unroll
    for (int cls = 0; cls < 4; ++cls) out.counts[p * 4 + cls] = static_cast<int32_t>(n[cls]);
    out.schedulable[p] = n[1] + n[2] + n[3] == 0;
  }
}

template <bool ON_EQUAL, bool STEP3_ON_EQUAL>
cudaError_t launch(const State& s, const Pods& pods, const Out& out, int P, int K, int T, int R,
                   bool statuses, int threads, int blocks, cudaStream_t stream) {
  if (statuses) {
    check_gather_kernel<ON_EQUAL, STEP3_ON_EQUAL, true>
        <<<blocks, threads, 0, stream>>>(s, pods, out, P, K, T, R);
  } else {
    check_gather_kernel<ON_EQUAL, STEP3_ON_EQUAL, false>
        <<<blocks, threads, 0, stream>>>(s, pods, out, P, K, T, R);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. ``write_statuses`` picks the form: 1
// writes ``statuses`` (``counts``/``schedulable`` may be null), 0 writes
// ``counts`` and ``schedulable`` (``statuses`` may be null). The geometry
// (threads per block, blocks) comes from the wrapper. Returns the
// cudaError_t of the launch (0 = cudaSuccess); the kernel runs
// asynchronously on ``stream``.
extern "C" int kt_check_gather(
    const uint8_t* valid, const int64_t* thr_cnt, const uint8_t* thr_cnt_present,
    const int64_t* thr_req, const uint8_t* thr_req_present, const int64_t* used_cnt,
    const uint8_t* used_cnt_present, const int64_t* used_req, const uint8_t* used_req_present,
    const int64_t* res_cnt, const uint8_t* res_cnt_present, const int64_t* res_req,
    const uint8_t* res_req_present, const uint8_t* st_cnt_throttled,
    const uint8_t* st_req_throttled, const uint8_t* st_req_flag_present,
    const uint8_t* pod_valid, const int64_t* pod_req, const uint8_t* pod_present,
    const int32_t* cols, int8_t* statuses, int32_t* counts, uint8_t* schedulable,
    int P, int K, int T, int R, int on_equal, int step3_on_equal, int write_statuses,
    int threads, int blocks, void* stream) {
  if (T < 1 || threads % kWarp != 0 || threads > kThreads ||
      static_cast<int64_t>(blocks) * (threads / kWarp) < P ||
      (write_statuses ? statuses == nullptr : counts == nullptr || schedulable == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const State s{valid, thr_cnt, thr_cnt_present, thr_req, thr_req_present, used_cnt,
                used_cnt_present, used_req, used_req_present, res_cnt, res_cnt_present,
                res_req, res_req_present, st_cnt_throttled, st_req_throttled,
                st_req_flag_present};
  const Pods pods{pod_valid, pod_req, pod_present, cols};
  const Out out{statuses, counts, schedulable};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w = write_statuses != 0;
  cudaError_t e;
  if (on_equal) {
    e = step3_on_equal ? launch<true, true>(s, pods, out, P, K, T, R, w, threads, blocks, st)
                       : launch<true, false>(s, pods, out, P, K, T, R, w, threads, blocks, st);
  } else {
    e = step3_on_equal ? launch<false, true>(s, pods, out, P, K, T, R, w, threads, blocks, st)
                       : launch<false, false>(s, pods, out, P, K, T, R, w, threads, blocks, st);
  }
  return static_cast<int>(e);
}
