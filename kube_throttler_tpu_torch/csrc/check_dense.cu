// Dense residual-form admission check: int8 status for every (pod, throttle)
// cell of a [P,T] selector mask.
//
// Replaces: kube_throttler_tpu/ops/pallas_check.py::pallas_check_pods (the
// Pallas TPU kernel _make_kernel(R, on_equal).kernel). It computes the same
// function, not the same blocks: the TPU kernel split every int64 into an
// int32 limb pair and needed P and T padded to its block; here the int64
// compares stay whole and any P and T run, the ragged edges masked here.
//
// Semantics (ops/fastcheck.py::fast_check_pods, the plain version), with
// nz(r) = pod present(r) && pod req(r) != 0:
//   exceeds  = exceeds_cnt || any_r nz && thr_present && req > thr_req
//   st_sat   = st_cnt || sat_cnt || any_r nz && (st_req || sat_req)
//   over     = over_cnt || any_r nz && thr_present && req >(=) resid
//   affected = mask[p,t] && pod valid[p] && throttle valid[t]
//   status   = !affected ? -1 : exceeds ? 3 : st_sat ? 1 : over ? 2 : 0
// sat_cnt/sat_req are the _ge planes when STEP3_ON_EQUAL, else _gt;
// over_cnt is over_cnt_ge when ON_EQUAL, else over_cnt_gt, and ">(=)" is
// ">=" when ON_EQUAL. Both flags are template parameters (4 kernels per R
// route); the kernel reads the CheckPrecomp planes as they are, so the
// wrapper enqueues nothing but the output's allocation and this launch.
//
// What bounds it: bytes. Each cell reads one mask byte and writes one
// status byte; the pod and throttle planes are small beside them. By
// chip_smoke.py's dense_bound at 3.35 TB/s: 0.0041 ms at the main path's
// 131072 x 16 x 8 (13.8 MB) and 0.805 ms at the dense sweep's
// 131072 x 10240 x 8 (2.7 GB), where the integer compares the data needs
// take 0.533 ms at the INT32 issue rate.
//
// What the design does about it:
// - A thread owns one throttle column. Its thresholds, residuals and the
//   variant-selected per-dim flag bits are loaded ONCE, when the thread
//   starts: into registers for R <= 16 (the R loop unrolled to an R bucket
//   of 8 or 16), else staged once into shared memory as [R][BT], where lane
//   t reads word t. The block is BT throttles wide (the smallest power of
//   two >= T in [16, 64]) and 256 / BT pod rows tall.
// - A block walks a strip of pod rows (grid.x: throttle tiles, grid.y: pod
//   strips, both chosen by ops/check_dense.py::_launch_shape), so the pod
//   planes are read once per throttle tile and the throttle planes once per
//   strip, and the loop has no barrier. A pod row is read through the
//   read-only path; every lane of a warp reads the same row (a broadcast).
// - The mask byte and pod/throttle validity come first; a cell that is not
//   affected skips the R loop. The pod-row loop is unrolled by 4, so each
//   thread has 4 mask loads in flight before it computes. A warp's mask
//   loads and status stores are 32 consecutive bytes along T.
// - No branch separates those loads, nor a pod row's R loads in the cell
//   body, so each group is in flight at once.
//
// What it does not reach: measured on an H100 it is bound by issued
// instructions, not bytes. Each lane repeats the pod row's loads, address
// arithmetic and 2 s64 compares per dim for its one column, so one step of
// 4 rows is several hundred SASS instructions per warp (chip_smoke.py
// prints the count). The next lever is to spread the per-row work over
// several columns per thread, so one pod row's loads serve each of them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;  // pod rows per thread per loop step

// per-throttle scalar bits, variant-selected when a thread starts
constexpr uint32_t C_VALID = 1, C_EXCEEDS = 2, C_ST_SAT = 4, C_OVER = 8;
// per-dim bits of the shared-memory route's flag plane
constexpr uint8_t F_PRESENT = 1, F_ST_SAT = 2;

struct Planes {
  const int64_t* __restrict__ pod_req;      // [P,R]
  const uint8_t* __restrict__ pod_present;  // [P,R]
  const uint8_t* __restrict__ pod_valid;    // [P]
  const int64_t* __restrict__ thr_req;      // [T,R]
  const int64_t* __restrict__ resid;        // [T,R]
  const uint8_t* __restrict__ thr_present;  // [T,R]
  const uint8_t* __restrict__ st_req;       // [T,R]
  const uint8_t* __restrict__ sat_req_ge;   // [T,R]
  const uint8_t* __restrict__ sat_req_gt;   // [T,R]
  const uint8_t* __restrict__ valid;        // [T]
  const uint8_t* __restrict__ exceeds_cnt;  // [T]
  const uint8_t* __restrict__ st_cnt;       // [T]
  const uint8_t* __restrict__ sat_cnt_ge;   // [T]
  const uint8_t* __restrict__ sat_cnt_gt;   // [T]
  const uint8_t* __restrict__ over_cnt_ge;  // [T]
  const uint8_t* __restrict__ over_cnt_gt;  // [T]
  const uint8_t* __restrict__ mask;         // [P,T]
  int8_t* __restrict__ out;                 // [P,T]
};

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

__device__ __forceinline__ bool ld1(const uint8_t* p) { return __ldg(p) != 0; }

template <bool ON_EQUAL, bool STEP3_ON_EQUAL>
__device__ __forceinline__ uint32_t column_bits(const Planes& a, int64_t t) {
  const bool sat = STEP3_ON_EQUAL ? ld1(a.sat_cnt_ge + t) : ld1(a.sat_cnt_gt + t);
  const bool over = ON_EQUAL ? ld1(a.over_cnt_ge + t) : ld1(a.over_cnt_gt + t);
  return (ld1(a.valid + t) ? C_VALID : 0) | (ld1(a.exceeds_cnt + t) ? C_EXCEEDS : 0) |
         ((ld1(a.st_cnt + t) | sat) ? C_ST_SAT : 0) | (over ? C_OVER : 0);
}

template <bool STEP3_ON_EQUAL>
__device__ __forceinline__ bool dim_st_sat(const Planes& a, int64_t g) {
  return ld1(a.st_req + g) | (STEP3_ON_EQUAL ? ld1(a.sat_req_ge + g) : ld1(a.sat_req_gt + g));
}

// The throttle column in registers: R <= RB, the loop unrolled to RB.
template <int RB>
struct RegColumn {
  static constexpr int kMaxR = RB;
  int64_t thr_[RB], res_[RB];
  uint32_t present_ = 0, st_sat_ = 0;

  template <bool STEP3_ON_EQUAL>
  __device__ __forceinline__ void load(const Planes& a, int64_t t, int R) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {  // no branch: dims past R read dim 0, zeroed
      const bool in = r < R;
      const int64_t g = t * R + (in ? r : 0);
      const int64_t thr = ld64(a.thr_req + g), res = ld64(a.resid + g);
      thr_[r] = in ? thr : 0;
      res_[r] = in ? res : 0;
      present_ |= static_cast<uint32_t>(in & ld1(a.thr_present + g)) << r;
      st_sat_ |= static_cast<uint32_t>(in & dim_st_sat<STEP3_ON_EQUAL>(a, g)) << r;
    }
  }
  __device__ __forceinline__ int64_t thr(int r) const { return thr_[r]; }
  __device__ __forceinline__ int64_t res(int r) const { return res_[r]; }
  __device__ __forceinline__ bool present(int r) const { return (present_ >> r) & 1u; }
  __device__ __forceinline__ bool st_sat(int r) const { return (st_sat_ >> r) & 1u; }
};

// The throttle column in the block's shared [R][BT] planes (R > 16).
struct SmemColumn {
  static constexpr int kMaxR = 0;  // runtime R
  const int64_t* thr_;
  const int64_t* res_;
  const uint8_t* flag_;
  int stride_;

  __device__ __forceinline__ int64_t thr(int r) const { return thr_[r * stride_]; }
  __device__ __forceinline__ int64_t res(int r) const { return res_[r * stride_]; }
  __device__ __forceinline__ bool present(int r) const { return flag_[r * stride_] & F_PRESENT; }
  __device__ __forceinline__ bool st_sat(int r) const { return flag_[r * stride_] & F_ST_SAT; }
};

// Status of one affected cell: pod row ``p`` against the thread's column.
// The body has no branch: every dim's loads are issued before its
// compares (an index past R reads dim 0 and is masked off), so the
// unrolled register route has the whole pod row in flight at once.
template <bool ON_EQUAL, class Col>
__device__ __forceinline__ int8_t classify(const Col& col, uint32_t cbits, const Planes& a,
                                           int64_t p, int R) {
  bool exceeds = cbits & C_EXCEEDS, st_sat = cbits & C_ST_SAT, over = cbits & C_OVER;
  const int64_t* req = a.pod_req + p * R;
  const uint8_t* present = a.pod_present + p * R;
  constexpr int kMaxR = Col::kMaxR;
#pragma unroll
  for (int r = 0; r < (kMaxR > 0 ? kMaxR : R); ++r) {
    const bool in = kMaxR == 0 || r < R;
    const int rr = in ? r : 0;
    const int64_t v = ld64(req + rr);
    const bool live = in & ld1(present + rr) & (v != 0);
    st_sat |= live & col.st_sat(r);
    const bool gate = live & col.present(r);
    exceeds |= gate & (v > col.thr(r));
    over |= gate & (ON_EQUAL ? (v >= col.res(r)) : (v > col.res(r)));
  }
  return exceeds ? 3 : st_sat ? 1 : over ? 2 : 0;
}

// Walk the block's strip of pod rows for the thread's throttle ``t``. The
// 4 rows' mask and pod-valid bytes are loaded with no branch between them
// (a row past the strip reads its last row and is dropped at the store).
template <bool ON_EQUAL, class Col>
__device__ __forceinline__ void walk_strip(const Col& col, uint32_t cbits, const Planes& a,
                                           int64_t t, int P, int T, int R, int strip) {
  const int64_t rows = blockDim.y;
  const int64_t p_begin = static_cast<int64_t>(blockIdx.y) * strip;
  const int64_t p_end = p_begin + strip < P ? p_begin + strip : P;
  const bool t_valid = cbits & C_VALID;
  for (int64_t p0 = p_begin + threadIdx.y; p0 < p_end; p0 += kUnroll * rows) {
    bool hit[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t p = p0 + k * rows;
      const int64_t pc = p < p_end ? p : p_end - 1;
      hit[k] = t_valid & ld1(a.mask + pc * T + t) & ld1(a.pod_valid + pc);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t p = p0 + k * rows;
      if (p >= p_end) break;
      a.out[p * T + t] = hit[k] ? classify<ON_EQUAL>(col, cbits, a, p, R) : int8_t(-1);
    }
  }
}

template <bool ON_EQUAL, bool STEP3_ON_EQUAL, int RB>
__global__ void __launch_bounds__(256) check_dense_reg(Planes a, int P, int T, int R, int strip) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= T) return;
  RegColumn<RB> col;
  col.template load<STEP3_ON_EQUAL>(a, t, R);
  const uint32_t cbits = column_bits<ON_EQUAL, STEP3_ON_EQUAL>(a, t);
  walk_strip<ON_EQUAL>(col, cbits, a, t, P, T, R, strip);
}

template <bool ON_EQUAL, bool STEP3_ON_EQUAL>
__global__ void __launch_bounds__(256) check_dense_smem(Planes a, int P, int T, int R, int strip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bt = blockDim.x;
  int64_t* s_thr = reinterpret_cast<int64_t*>(smem);    // [R][bt]
  int64_t* s_res = s_thr + static_cast<int64_t>(R) * bt;  // [R][bt]
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_res + static_cast<int64_t>(R) * bt);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * bt;
  // stage once: global reads walk r fastest, shared writes transpose
  const int nthreads = bt * blockDim.y;
  for (int i = threadIdx.y * bt + threadIdx.x; i < bt * R; i += nthreads) {
    const int tt = i / R, r = i - tt * R;
    const int64_t tg = t0 + tt;
    int64_t thr = 0, res = 0;
    uint8_t flag = 0;
    if (tg < T) {
      const int64_t g = tg * R + r;
      thr = ld64(a.thr_req + g);
      res = ld64(a.resid + g);
      flag = (ld1(a.thr_present + g) ? F_PRESENT : 0) |
             (dim_st_sat<STEP3_ON_EQUAL>(a, g) ? F_ST_SAT : 0);
    }
    s_thr[r * bt + tt] = thr;
    s_res[r * bt + tt] = res;
    s_flag[r * bt + tt] = flag;
  }
  __syncthreads();
  const int64_t t = t0 + threadIdx.x;
  if (t >= T) return;
  const SmemColumn col{s_thr + threadIdx.x, s_res + threadIdx.x, s_flag + threadIdx.x, bt};
  const uint32_t cbits = column_bits<ON_EQUAL, STEP3_ON_EQUAL>(a, t);
  walk_strip<ON_EQUAL>(col, cbits, a, t, P, T, R, strip);
}

template <bool ON_EQUAL, bool STEP3_ON_EQUAL>
cudaError_t launch(const Planes& a, int P, int T, int R, dim3 block, dim3 grid, int strip,
                   int rbucket, int smem, cudaStream_t stream) {
  if (rbucket == 8) {
    check_dense_reg<ON_EQUAL, STEP3_ON_EQUAL, 8><<<grid, block, 0, stream>>>(a, P, T, R, strip);
  } else if (rbucket == 16) {
    check_dense_reg<ON_EQUAL, STEP3_ON_EQUAL, 16><<<grid, block, 0, stream>>>(a, P, T, R, strip);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(check_dense_smem<ON_EQUAL, STEP3_ON_EQUAL>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
      if (e != cudaSuccess) return e;
    }
    check_dense_smem<ON_EQUAL, STEP3_ON_EQUAL><<<grid, block, smem, stream>>>(a, P, T, R, strip);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. The launch geometry (block, grid, strip
// of pod rows per block, R route, dynamic shared memory) comes from the
// wrapper. Returns the cudaError_t of the launch (0 = cudaSuccess); the
// kernel runs asynchronously on ``stream``.
extern "C" int kt_check_dense(
    const int64_t* pod_req, const uint8_t* pod_present, const uint8_t* pod_valid,
    const int64_t* thr_req, const int64_t* resid, const uint8_t* thr_present,
    const uint8_t* st_req, const uint8_t* sat_req_ge, const uint8_t* sat_req_gt,
    const uint8_t* valid, const uint8_t* exceeds_cnt, const uint8_t* st_cnt,
    const uint8_t* sat_cnt_ge, const uint8_t* sat_cnt_gt, const uint8_t* over_cnt_ge,
    const uint8_t* over_cnt_gt, const uint8_t* mask, int8_t* out,
    int P, int T, int R, int on_equal, int step3_on_equal,
    int block_x, int block_y, int grid_x, int grid_y, int strip, int rbucket, int smem,
    void* stream) {
  const bool reg_route = rbucket == 8 || rbucket == 16;
  if ((reg_route && R > rbucket) || (!reg_route && rbucket != 0) ||
      (rbucket == 0 && static_cast<int64_t>(smem) < static_cast<int64_t>(block_x) * R * 17)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Planes a{pod_req, pod_present, pod_valid, thr_req, resid, thr_present, st_req,
                 sat_req_ge, sat_req_gt, valid, exceeds_cnt, st_cnt, sat_cnt_ge, sat_cnt_gt,
                 over_cnt_ge, over_cnt_gt, mask, out};
  const dim3 block(block_x, block_y), grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (on_equal) {
    e = step3_on_equal ? launch<true, true>(a, P, T, R, block, grid, strip, rbucket, smem, s)
                       : launch<true, false>(a, P, T, R, block, grid, strip, rbucket, smem, s);
  } else {
    e = step3_on_equal ? launch<false, true>(a, P, T, R, block, grid, strip, rbucket, smem, s)
                       : launch<false, false>(a, P, T, R, block, grid, strip, rbucket, smem, s);
  }
  return static_cast<int>(e);
}
