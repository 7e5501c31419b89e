// Sparse gather admission check: for each pod, the ordered 4-step check
// against the K throttle rows its matched cols name, reduced to per-pod
// class counts or written as per-slot statuses. Two kernels per call: a
// pack of the ThrottleState planes into one record per throttle row, then
// the check over the records.
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
// status of every slot.
//
// The record of throttle row t (ops/check_gather.py::record_layout owns the
// sizes; pack_gather_rows_reference writes the same bytes in torch ops):
// W = max(1, ceil(R / 32)) mask words per dim mask, a header of
// header_words = 4 * ceil((W + 1) / 2) int64 words (whole 32-byte sectors),
// then R dim slots of 16 bytes, the record padded to
// words = header_words + 4 * ceil(R / 2) int64 words; records are
// contiguous, row t at int64 word t * words, so every record starts on a
// sector.
//   bytes  0..7    thr_cnt                               int64
//   bytes  8..15   au_cnt = used_cnt + res_cnt           int64 (wrapping)
//   bytes 16 + 16w, for mask group w in [0, W): four u32
//          lead    w = 0: bit 0 valid, bit 1 thr_cnt_present,
//                  bit 2 used_cnt_present | res_cnt_present,
//                  bit 3 st_cnt_throttled; w > 0: 0
//          thr     bit j = thr_req_present[t, 32w + j]
//          au      bit j = used_req_present | res_req_present
//          st      bit j = st_req_flag_present & st_req_throttled
//   bytes 8 * header_words + 16r, for dim r in [0, R): two int64
//          thr_req[t, r], au_req = used_req + res_req (wrapping)
// Every other byte (a mask bit past R, the padding) is 0. At R <= 32 the
// header is the record's first sector and a requested dim its own sector:
// a live slot whose pod requests one dim reads 2 sectors, where reading
// the 16 planes field by field touched about 16.
//
// What bounds it: bytes, by the count that chip_smoke.py computes from the
// run's data (gather_bound: cols read once, the pod planes read once, each
// throttle row and (row, dim) that the cols need read once, the outputs
// written once): 0.00644 ms at the main path's tick state (131072 x 32 x 8,
// T = 16384). That count leaves out the pack, which reads every plane once
// and writes the records once; the wrapper's time includes it. The
// one-kernel design before this one read the 16 planes field by field: 16
// scattered loads a live slot, each in its own sector, behind a serial
// loop over R, at about 34x that bound alone. The records cut a live slot to 3
// loads in 2 sectors and the loop to a bitmask; what is left is memory
// latency (each warp waits on its pods' rows from HBM, then on their
// records from L2) rather than bytes (PERF.md section 6).
//
// What the design does about it:
// - pack_gather_rows_kernel: one warp per row, grid-stride; lane j takes
//   dim j of every [T,R] plane, so a row's read of each plane is one run
//   of consecutive bytes, writes its 16-byte dim slot, and the warp's
//   ballots are the masks. It runs on the caller's stream just before the
//   check, from the very planes the check would have read; nothing
//   outlives the call.
// - check_gather_kernel: one warp takes two pods, its lanes striding over
//   both pods' K slots together, so every K (4 to 2048) takes the same
//   code and each lane has two slots' loads in flight (at the tick's state
//   a pod has ~20 live slots of 32, and the kernel waits on memory, not on
//   issue). Each pod's requested-nonzero dims are a warp-uniform bitmask
//   per 32 dims (a ballot); word 0 is computed once per pod, its loads in
//   flight beside the first cols', and the first requested dim's request
//   is shuffled to every lane. A lane clamps its col, loads the record's
//   header with two 16-byte read-only loads and, issued beside them, the
//   16-byte slot of the pod's first requested dim; then the slot of every
//   further requested dim whose threshold is present. The next trip's
//   cols are loaded one trip ahead. The st mask ANDed with the pod mask is
//   step 2 for 32 dims at once.
// - The per-pod class counts are a __ballot_sync per class and __popc;
//   lane 0 writes each pod's int32[4] and schedulable gate.
// - Blocks of 256 threads hold 16 pods; the grid is ceil(P / 16) blocks
//   on grid.x (ops/check_gather.py::_launch_shape owns both kernels'
//   geometry; the C entries only check what they are handed).
// Instantiations: both variant flags and the form are template parameters
// of the check (8 kernels), plus the pack.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;      // ops/check_gather.py::_THREADS
constexpr int kPodsPerWarp = 2;    // ops/check_gather.py::_PODS_PER_WARP
constexpr int kPackThreads = 256;  // ops/check_gather.py::_PACK_THREADS

// the lead word of mask group 0
constexpr uint32_t kValid = 1u, kThrCntP = 2u, kAuCntP = 4u, kStCnt = 8u;

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

struct Layout {  // ops/check_gather.py::record_layout
  int R, W, header_words, words;
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

__device__ __forceinline__ longlong2 ld128(const int64_t* p) {
  return __ldg(reinterpret_cast<const longlong2*>(p));
}

__device__ __forceinline__ uint32_t ld1(const uint8_t* p) { return __ldg(p) != 0; }

// a + b with two's-complement wrap, as torch and XLA add int64
__device__ __forceinline__ int64_t wrap_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}

template <bool ON_EQUAL>
__device__ __forceinline__ bool cmp(int64_t u, int64_t t) {
  return ON_EQUAL ? u >= t : u > t;
}

// ---------------------------------------------------------------- pack

__device__ __forceinline__ void st128(int64_t* p, int64_t a, int64_t b) {
  *reinterpret_cast<longlong2*>(p) = make_longlong2(a, b);
}

// One warp per row, striding over the rows. Lane j takes dim 32w + j of
// every [T,R] plane, so each plane's read of a row is one run of
// consecutive bytes, and writes that dim's 16-byte slot; the warp's
// ballots are mask group w. Lane 0 reads the [T] planes first, so those
// loads fly beside the dims', and writes the count side and the groups.
__global__ void __launch_bounds__(kPackThreads)
    pack_gather_rows_kernel(State s, Layout l, int64_t* __restrict__ packed, int64_t T) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  for (int64_t t = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp; t < T;
       t += warps) {  // t is the warp's: every lane takes the same trips
    int64_t* rec = packed + t * l.words;
    int64_t thr_cnt = 0, au_cnt = 0;
    uint32_t lead = 0;
    if (lane == 0) {
      thr_cnt = ld64(s.thr_cnt + t);
      au_cnt = wrap_add(ld64(s.used_cnt + t), ld64(s.res_cnt + t));
      lead = ld1(s.valid + t) * kValid | ld1(s.thr_cnt_present + t) * kThrCntP |
             (ld1(s.used_cnt_present + t) | ld1(s.res_cnt_present + t)) * kAuCntP |
             ld1(s.st_cnt_throttled + t) * kStCnt;
    }
    for (int w = 0; w < l.W; ++w) {
      const int r = 32 * w + lane;
      bool thr_p = false, au_p = false, st = false;
      if (r < l.R) {
        const int64_t g = t * l.R + r;
        thr_p = ld1(s.thr_req_present + g);
        au_p = ld1(s.used_req_present + g) | ld1(s.res_req_present + g);
        st = ld1(s.st_req_flag_present + g) & ld1(s.st_req_throttled + g);
        st128(rec + l.header_words + 2 * r, ld64(s.thr_req + g),
              wrap_add(ld64(s.used_req + g), ld64(s.res_req + g)));
      }
      const uint32_t m_thr = __ballot_sync(0xffffffffu, thr_p);
      const uint32_t m_au = __ballot_sync(0xffffffffu, au_p);
      const uint32_t m_st = __ballot_sync(0xffffffffu, st);
      if (lane == 0) {
        st128(rec + 2 + 2 * w,
              static_cast<int64_t>((w == 0 ? lead : 0u) | static_cast<uint64_t>(m_thr) << 32),
              static_cast<int64_t>(m_au | static_cast<uint64_t>(m_st) << 32));
      }
    }
    if (lane == 0) st128(rec, thr_cnt, au_cnt);
    // the padding: header words past the last group, record words past dim R - 1
    const int pad0 = 2 + 2 * l.W, pad1 = l.header_words + 2 * l.R;
    for (int k = lane; k < l.words; k += kWarp) {
      if ((k >= pad0 && k < l.header_words) || k >= pad1) rec[k] = 0;
    }
  }
}

// ---------------------------------------------------------------- check

// Bit j: the pod requests dim 32w + j, nonzero; ``v`` gets the lane's own
// request (dim 32w + lane). Every lane of the warp must call it (a
// ballot); the result is the same in every lane.
__device__ __forceinline__ uint32_t pod_mask(const int64_t* req, const uint8_t* present, int R,
                                             int w, int lane, int64_t& v) {
  const int r = 32 * w + lane;
  bool p = false;
  v = 0;
  if (r < R) {  // both loads in flight together
    p = ld1(present + r);
    v = ld64(req + r);
  }
  return __ballot_sync(0xffffffffu, p && v != 0);
}

// One requested dim whose threshold is present: slot d = {thr, au}.
template <bool ON_EQUAL, bool STEP3_ON_EQUAL>
__device__ __forceinline__ void dim_step(int64_t v, longlong2 d, bool au_p, bool& exceeds,
                                         bool& active, bool& over) {
  exceeds |= v > d.x;
  active |= au_p & cmp<STEP3_ON_EQUAL>(d.y, d.x);
  over |= cmp<ON_EQUAL>(wrap_add(d.y, v), d.x);
}

// A pod of the warp: its planes, the mask of its requested dims 0..31 and
// the first of them with its request, and the lane's col of this trip.
struct Pod {
  const int64_t* req;
  const uint8_t* present;
  const int32_t* cols;
  bool ok;
  uint32_t m0;
  int r0;
  int64_t v0;
  int col;
};

// One slot's steps over dims 0..31, from its header {h0, h1} and the slot
// d0 of the pod's first requested dim (loaded beside the header); a
// further requested dim is read here. Sets live; the steps accumulate.
template <bool ON_EQUAL, bool STEP3_ON_EQUAL>
__device__ __forceinline__ void slot_steps(const Pod& pod, const int64_t* rec, const Layout& l,
                                           longlong2 h0, longlong2 h1, longlong2 d0, bool& live,
                                           bool& exceeds, bool& active, bool& over) {
  const uint32_t lead = static_cast<uint32_t>(h1.x);
  live = lead & kValid;
  if (!live) return;
  const bool thr_cnt_p = lead & kThrCntP;
  const int64_t thr_cnt = h0.x, au_cnt = h0.y;
  const uint32_t m_thr = static_cast<uint32_t>(static_cast<uint64_t>(h1.x) >> 32);
  const uint32_t m_au = static_cast<uint32_t>(h1.y);
  const uint32_t m_st = static_cast<uint32_t>(static_cast<uint64_t>(h1.y) >> 32);
  exceeds = thr_cnt_p & (thr_cnt < 1);
  active = (lead & kStCnt) || (m_st & pod.m0) ||
           (thr_cnt_p && (lead & kAuCntP) && cmp<STEP3_ON_EQUAL>(au_cnt, thr_cnt));
  over = thr_cnt_p & cmp<ON_EQUAL>(wrap_add(au_cnt, 1), thr_cnt);
  if (pod.r0 >= 0 && ((m_thr >> pod.r0) & 1u)) {
    dim_step<ON_EQUAL, STEP3_ON_EQUAL>(pod.v0, d0, (m_au >> pod.r0) & 1u, exceeds, active, over);
  }
  for (uint32_t m = pod.m0 & (pod.m0 - 1) & m_thr; m; m &= m - 1) {
    const int r = __ffs(m) - 1;
    dim_step<ON_EQUAL, STEP3_ON_EQUAL>(ld64(pod.req + r), ld128(rec + l.header_words + 2 * r),
                                       (m_au >> r) & 1u, exceeds, active, over);
  }
}

template <bool ON_EQUAL, bool STEP3_ON_EQUAL, bool STATUSES>
__global__ void __launch_bounds__(kThreads)
    check_gather_kernel(const int64_t* __restrict__ packed, Layout l, Pods pods, Out out, int P,
                        int K, int T) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t p0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp * kPodsPerWarp;
  if (p0 >= P) return;  // the whole warp: p0 is the warp's
  Pod pod[kPodsPerWarp];
  int64_t v[kPodsPerWarp];
#pragma unroll
  for (int j = 0; j < kPodsPerWarp; ++j) {  // every pod's loads in flight together
    const bool in = p0 + j < P;
    const int64_t p = in ? p0 + j : p0;
    pod[j].ok = in && ld1(pods.valid + p);
    pod[j].req = pods.req + p * l.R;
    pod[j].present = pods.present + p * l.R;
    pod[j].cols = pods.cols + p * K;
    pod[j].col = in && lane < K ? __ldg(pod[j].cols + lane) : -1;
  }
#pragma unroll
  for (int j = 0; j < kPodsPerWarp; ++j) {
    pod[j].m0 = pod_mask(pod[j].req, pod[j].present, l.R, 0, lane, v[j]);
    pod[j].r0 = __ffs(pod[j].m0) - 1;  // the first requested dim, -1 for none
    pod[j].v0 = __shfl_sync(0xffffffffu, v[j], pod[j].r0 < 0 ? 0 : pod[j].r0);  // its request
  }
  uint32_t n[kPodsPerWarp][4] = {};
  for (int k0 = 0; k0 < K; k0 += kWarp) {  // uniform trip count: every lane ballots
    const int k = k0 + lane;
    const int64_t* rec[kPodsPerWarp];
    longlong2 h0[kPodsPerWarp], h1[kPodsPerWarp], d0[kPodsPerWarp];
    int next[kPodsPerWarp];
#pragma unroll
    for (int j = 0; j < kPodsPerWarp; ++j) {  // every slot's loads in flight together
      const int col = pod[j].col;
      next[j] = k + kWarp < K && p0 + j < P ? __ldg(pod[j].cols + k + kWarp) : -1;
      rec[j] = packed + static_cast<int64_t>(col < 0 ? 0 : col < T ? col : T - 1) * l.words;
      h0[j] = h1[j] = d0[j] = make_longlong2(0, 0);
      if (col >= 0 && pod[j].ok) {
        h0[j] = ld128(rec[j]);
        h1[j] = ld128(rec[j] + 2);
        if (pod[j].r0 >= 0) d0[j] = ld128(rec[j] + l.header_words + 2 * pod[j].r0);
      }
    }
#pragma unroll
    for (int j = 0; j < kPodsPerWarp; ++j) {
      bool live = false, exceeds = false, active = false, over = false;
      if (pod[j].col >= 0 && pod[j].ok) {
        slot_steps<ON_EQUAL, STEP3_ON_EQUAL>(pod[j], rec[j], l, h0[j], h1[j], d0[j], live,
                                             exceeds, active, over);
      }
      for (int w = 1; w < l.W; ++w) {  // R > 32 only; every lane ballots
        const uint32_t mw = pod_mask(pod[j].req, pod[j].present, l.R, w, lane, v[j]);
        if (live && mw) {
          const longlong2 g = ld128(rec[j] + 2 + 2 * w);
          const uint32_t m_thr = static_cast<uint32_t>(static_cast<uint64_t>(g.x) >> 32);
          const uint32_t m_au = static_cast<uint32_t>(g.y);
          const uint32_t m_st = static_cast<uint32_t>(static_cast<uint64_t>(g.y) >> 32);
          active |= (m_st & mw) != 0;
          for (uint32_t m = mw & m_thr; m; m &= m - 1) {
            const int b = __ffs(m) - 1;
            const int r = 32 * w + b;
            dim_step<ON_EQUAL, STEP3_ON_EQUAL>(ld64(pod[j].req + r),
                                               ld128(rec[j] + l.header_words + 2 * r),
                                               (m_au >> b) & 1u, exceeds, active, over);
          }
        }
      }
      const int8_t st = !live ? -1 : exceeds ? 3 : active ? 1 : over ? 2 : 0;
      if (STATUSES) {
        if (k < K && p0 + j < P) out.statuses[(p0 + j) * K + k] = st;
      } else {
#pragma unroll
        for (int cls = 0; cls < 4; ++cls) {
          n[j][cls] += __popc(__ballot_sync(0xffffffffu, st == cls));
        }
      }
      pod[j].col = next[j];
    }
  }
  if (!STATUSES && lane == 0) {
#pragma unroll
    for (int j = 0; j < kPodsPerWarp; ++j) {
      if (p0 + j >= P) continue;
#pragma unroll
      for (int cls = 0; cls < 4; ++cls) {
        out.counts[(p0 + j) * 4 + cls] = static_cast<int32_t>(n[j][cls]);
      }
      out.schedulable[p0 + j] = n[j][1] + n[j][2] + n[j][3] == 0;
    }
  }
}

template <bool ON_EQUAL, bool STEP3_ON_EQUAL>
cudaError_t launch(const int64_t* packed, const Layout& l, const Pods& pods, const Out& out, int P,
                   int K, int T, bool statuses, int threads, int blocks, cudaStream_t stream) {
  if (statuses) {
    check_gather_kernel<ON_EQUAL, STEP3_ON_EQUAL, true>
        <<<blocks, threads, 0, stream>>>(packed, l, pods, out, P, K, T);
  } else {
    check_gather_kernel<ON_EQUAL, STEP3_ON_EQUAL, false>
        <<<blocks, threads, 0, stream>>>(packed, l, pods, out, P, K, T);
  }
  return cudaGetLastError();
}

// The layout the wrapper hands over, checked against R: whole sectors,
// room for W mask groups in the header and for R dim slots after it.
bool layout_ok(int R, int header_words, int words, Layout* l) {
  if (R < 0 || header_words % 4 != 0 || words % 4 != 0) return false;
  const int W = R > 32 ? (R + 31) / 32 : 1;
  if (8LL * header_words < 16 + 16LL * W || words < header_words + 2LL * R) return false;
  *l = Layout{R, W, header_words, words};
  return true;
}

}  // namespace

// Plain C entry points for ctypes. Each returns the cudaError_t of its
// launch (0 = cudaSuccess; cudaErrorInvalidValue for arguments it refuses)
// and runs asynchronously on ``stream``. The record layout (header_words,
// words) and the geometry (threads per block, blocks) come from the
// wrapper.

// Writes ``packed`` int64[T, words]: row t's record from the 16
// ThrottleState planes.
extern "C" int kt_pack_gather_rows(
    const uint8_t* valid, const int64_t* thr_cnt, const uint8_t* thr_cnt_present,
    const int64_t* thr_req, const uint8_t* thr_req_present, const int64_t* used_cnt,
    const uint8_t* used_cnt_present, const int64_t* used_req, const uint8_t* used_req_present,
    const int64_t* res_cnt, const uint8_t* res_cnt_present, const int64_t* res_req,
    const uint8_t* res_req_present, const uint8_t* st_cnt_throttled,
    const uint8_t* st_req_throttled, const uint8_t* st_req_flag_present, int64_t* packed,
    int T, int R, int header_words, int words, int threads, int blocks, void* stream) {
  Layout l;
  if (T < 1 || packed == nullptr || !layout_ok(R, header_words, words, &l) || threads < kWarp ||
      threads % kWarp != 0 || threads > kPackThreads || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const State s{valid, thr_cnt, thr_cnt_present, thr_req, thr_req_present, used_cnt,
                used_cnt_present, used_req, used_req_present, res_cnt, res_cnt_present,
                res_req, res_req_present, st_cnt_throttled, st_req_throttled,
                st_req_flag_present};
  pack_gather_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(s, l, packed,
                                                                                     T);
  return static_cast<int>(cudaGetLastError());
}

// ``write_statuses`` picks the form: 1 writes ``statuses`` (``counts``/
// ``schedulable`` may be null), 0 writes ``counts`` and ``schedulable``
// (``statuses`` may be null). ``packed`` is kt_pack_gather_rows' output
// for the same T and layout.
extern "C" int kt_check_gather(
    const int64_t* packed, const uint8_t* pod_valid, const int64_t* pod_req,
    const uint8_t* pod_present, const int32_t* cols, int8_t* statuses, int32_t* counts,
    uint8_t* schedulable, int P, int K, int T, int R, int header_words, int words, int on_equal,
    int step3_on_equal, int write_statuses, int threads, int blocks, void* stream) {
  Layout l;
  if (T < 1 || packed == nullptr || !layout_ok(R, header_words, words, &l) ||
      threads % kWarp != 0 || threads > kThreads ||
      static_cast<int64_t>(blocks) * (threads / kWarp) * kPodsPerWarp < P ||
      (write_statuses ? statuses == nullptr : counts == nullptr || schedulable == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pods pods{pod_valid, pod_req, pod_present, cols};
  const Out out{statuses, counts, schedulable};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w = write_statuses != 0;
  cudaError_t e;
  if (on_equal) {
    e = step3_on_equal ? launch<true, true>(packed, l, pods, out, P, K, T, w, threads, blocks, st)
                       : launch<true, false>(packed, l, pods, out, P, K, T, w, threads, blocks, st);
  } else {
    e = step3_on_equal ? launch<false, true>(packed, l, pods, out, P, K, T, w, threads, blocks, st)
                       : launch<false, false>(packed, l, pods, out, P, K, T, w, threads, blocks, st);
  }
  return static_cast<int>(e);
}
