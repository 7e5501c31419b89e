// Dense residual-form admission check: int8 status for every (pod, throttle)
// cell of a [P,T] selector mask.
//
// Replaces: kube_throttler_tpu/ops/pallas_check.py::pallas_check_pods (the
// Pallas TPU kernel _make_kernel(R, on_equal).kernel). It recomputes the same
// function, not the same blocks: the TPU kernel split every int64 into an
// int32 limb pair because the TPU emulates s64; Hopper compares s64 directly,
// so the operands stay int64. Throttle planes stay [T,R] row-major.
//
// Semantics (ops/fastcheck.py::fast_check_pods, the plain version):
//   gate(r)    = pod_nz[p,r] && (tflag[t,r] & THR_PRESENT)
//   exceeds    = tvec EXCEEDS_CNT || any_r gate && pod_req > thr_req
//   st_or_sat  = tvec ST_OR_SAT   || any_r pod_nz && (tflag & ST_OR_SAT)
//   over       = tvec OVER_CNT    || any_r gate && pod_req >(=) resid
//   affected   = mask[p,t] && pod_valid[p] && tvec VALID
//   status     = !affected ? -1 : exceeds ? 3 : st_or_sat ? 1 : over ? 2 : 0
// The wrapper (ops/check_dense.py) resolves the step-3/step-4 variants into
// tflag/tvec bits before the launch, so the kernel has one compile-time flag:
// the step-4 strictness (ON_EQUAL).
//
// What bounds it: each cell reads one mask byte and writes one status byte;
// an affected cell does two s64 compares per dim live on both sides (each a
// pair of 32-bit ISETPs on the INT32 pipe, 64 lanes per SM, a quarter of the
// FP32 FLOP rate). Which of the two binds depends on the data: the byte
// traffic is fixed by P*T, the compares scale with the share of affected
// cells and live dims. chip_smoke.py prints both bounds for each timed
// shape. At small T the launch dominates either.
//
// What the design does about it: one thread per cell; the block's pod rows
// and throttle rows are staged ONCE in shared memory (the reuse the Pallas
// kernel got from VMEM), so device memory sees each pod row once per
// throttle tile and each throttle row once per pod tile, and the mask and
// status bytes are read and written once, coalesced along T. Throttle planes
// are transposed to [R][BT] in shared memory so a warp's 32 throttles read
// consecutive words; a warp's pod operand is a broadcast. Any P and T: the
// ragged edge is masked here, not padded by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint8_t THR_PRESENT = 1;  // tflag bit: threshold dim present
constexpr uint8_t ST_OR_SAT = 2;    // tflag bit: st_req | sat_req (variant)

constexpr uint8_t TV_EXCEEDS_CNT = 1;  // tvec bits
constexpr uint8_t TV_ST_OR_SAT = 2;
constexpr uint8_t TV_OVER_CNT = 4;
constexpr uint8_t TV_VALID = 8;

template <bool ON_EQUAL>
__global__ void check_dense_kernel(
    const int64_t* __restrict__ pod_req,   // [P,R]
    const uint8_t* __restrict__ pod_nz,    // [P,R] present && != 0
    const uint8_t* __restrict__ pod_valid, // [P]
    const int64_t* __restrict__ thr_req,   // [T,R]
    const int64_t* __restrict__ resid,     // [T,R]
    const uint8_t* __restrict__ tflag,     // [T,R]
    const uint8_t* __restrict__ tvec,      // [T]
    const uint8_t* __restrict__ mask,      // [P,T]
    int8_t* __restrict__ out,              // [P,T]
    int P, int T, int R) {
  const int bt = blockDim.x;  // throttles per block
  const int bp = blockDim.y;  // pods per block
  const int p0 = blockIdx.x * bp;
  const int t0 = blockIdx.y * bt;
  const int tid = threadIdx.y * bt + threadIdx.x;
  const int nthreads = bt * bp;

  // dynamic shared memory: the int64 planes first (8-byte aligned), bytes after
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_thr = reinterpret_cast<int64_t*>(smem);  // [R][bt]
  int64_t* s_resid = s_thr + R * bt;                   // [R][bt]
  int64_t* s_pod = s_resid + R * bt;                   // [bp][R]
  uint8_t* s_tflag = reinterpret_cast<uint8_t*>(s_pod + bp * R);  // [R][bt]
  uint8_t* s_pnz = s_tflag + R * bt;                   // [bp][R]
  uint8_t* s_tvec = s_pnz + bp * R;                    // [bt]
  uint8_t* s_pvalid = s_tvec + bt;                     // [bp]

  // stage the throttle tile: global reads walk r fastest (coalesced),
  // shared writes transpose to [R][bt]; rows past T stage as absent
  for (int i = tid; i < bt * R; i += nthreads) {
    const int t = i / R, r = i - t * R;
    const int tg = t0 + t;
    const bool in = tg < T;
    const int64_t g = static_cast<int64_t>(tg) * R + r;
    s_thr[r * bt + t] = in ? thr_req[g] : 0;
    s_resid[r * bt + t] = in ? resid[g] : 0;
    s_tflag[r * bt + t] = in ? tflag[g] : 0;
  }
  for (int t = tid; t < bt; t += nthreads) {
    s_tvec[t] = (t0 + t < T) ? tvec[t0 + t] : 0;
  }
  // stage the pod tile, [bp][R] as in global memory
  for (int i = tid; i < bp * R; i += nthreads) {
    const int p = i / R;
    const bool in = p0 + p < P;
    const int64_t g = static_cast<int64_t>(p0) * R + i;
    s_pod[i] = in ? pod_req[g] : 0;
    s_pnz[i] = in ? pod_nz[g] : 0;
  }
  for (int p = tid; p < bp; p += nthreads) {
    s_pvalid[p] = (p0 + p < P) ? pod_valid[p0 + p] : 0;
  }
  __syncthreads();

  const int tx = threadIdx.x, py = threadIdx.y;
  const int p = p0 + py, t = t0 + tx;
  if (p >= P || t >= T) return;

  bool exceeds = false, st_or_sat = false, over = false;
  const int64_t* prow = s_pod + py * R;
  const uint8_t* pnz = s_pnz + py * R;
  for (int r = 0; r < R; ++r) {
    if (!pnz[r]) continue;
    const uint8_t f = s_tflag[r * bt + tx];
    st_or_sat |= (f & ST_OR_SAT) != 0;
    if (f & THR_PRESENT) {
      const int64_t v = prow[r];
      exceeds |= v > s_thr[r * bt + tx];
      over |= ON_EQUAL ? (v >= s_resid[r * bt + tx]) : (v > s_resid[r * bt + tx]);
    }
  }
  const uint8_t tv = s_tvec[tx];
  exceeds |= (tv & TV_EXCEEDS_CNT) != 0;
  st_or_sat |= (tv & TV_ST_OR_SAT) != 0;
  over |= (tv & TV_OVER_CNT) != 0;

  const int64_t cell = static_cast<int64_t>(p) * T + t;
  const bool affected = mask[cell] && s_pvalid[py] && (tv & TV_VALID);
  int8_t s;
  if (!affected) s = -1;
  else if (exceeds) s = 3;
  else if (st_or_sat) s = 1;
  else if (over) s = 2;
  else s = 0;
  out[cell] = s;
}

template <bool ON_EQUAL>
cudaError_t launch(const int64_t* pod_req, const uint8_t* pod_nz, const uint8_t* pod_valid,
                   const int64_t* thr_req, const int64_t* resid, const uint8_t* tflag,
                   const uint8_t* tvec, const uint8_t* mask, int8_t* out,
                   int P, int T, int R, int bt, int bp, cudaStream_t stream) {
  const size_t smem = sizeof(int64_t) * (2 * static_cast<size_t>(R) * bt + static_cast<size_t>(bp) * R) +
                      static_cast<size_t>(R) * bt + static_cast<size_t>(bp) * R + bt + bp;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(check_dense_kernel<ON_EQUAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 block(bt, bp);
  dim3 grid((P + bp - 1) / bp, (T + bt - 1) / bt);
  check_dense_kernel<ON_EQUAL><<<grid, block, smem, stream>>>(
      pod_req, pod_nz, pod_valid, thr_req, resid, tflag, tvec, mask, out, P, T, R);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Returns the cudaError_t of the launch
// (0 = cudaSuccess); the kernel runs asynchronously on ``stream``.
extern "C" int kt_check_dense(
    const int64_t* pod_req, const uint8_t* pod_nz, const uint8_t* pod_valid,
    const int64_t* thr_req, const int64_t* resid, const uint8_t* tflag,
    const uint8_t* tvec, const uint8_t* mask, int8_t* out,
    int P, int T, int R, int on_equal, int bt, int bp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (on_equal) {
    return static_cast<int>(launch<true>(pod_req, pod_nz, pod_valid, thr_req, resid, tflag,
                                         tvec, mask, out, P, T, R, bt, bp, s));
  }
  return static_cast<int>(launch<false>(pod_req, pod_nz, pod_valid, thr_req, resid, tflag,
                                        tvec, mask, out, P, T, R, bt, bp, s));
}
