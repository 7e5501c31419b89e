// Greedy ranked-prefix victim selection: one block walks the ranked
// candidate rows in order. A consumer warp decides each row with a warp
// vote, while a producer warp streams the rows into a shared-memory ring.
//
// Replaces: kube_throttler_tpu/ops/victim_select.py::victim_select (an XLA
// lax.scan in the JAX package, not a Pallas kernel). The same recurrence,
// with remaining = deficit at the start:
//   helps    = any_j contrib[i,j] > 0 && remaining[j] > 0
//   take     = helps && (cap <= 0 || count < cap)
//   if take: remaining -= contrib[i,:]; count += 1
//   selected[i] = take;  ok = all_j remaining[j] <= 0
// remaining -= row wraps as two's complement, as torch and XLA subtract
// int64. Signed overflow is undefined in C++, so the subtraction goes
// through uint64_t (as check_gather.cu's adds do); compares are signed. No
// float appears. A negative contribution may reopen a met dim: nothing here
// assumes that remaining only falls.
//
// What bounds it: neither bytes nor operations, but the N sequential steps.
// Whether row i is taken depends on every earlier take, so the walk is one
// chain of dependent decisions, and its time is the rows walked times the
// latency of one link. The rows themselves do not depend on any take.
//
// What the design does about it: one launch of one block (the chain cannot
// be split across SMs), with no block-wide barrier on the per-row chain.
// - The walkers. C consumer warps (1 up to M = 64, else 8: the counts
//   measured fastest) hold remaining in registers: consumer thread t
//   (0 <= t < 32C) owns columns t, t + 32C, t + 64C, ..., up to KREG of
//   them (KREG a power of two up to 32). C and KREG are template
//   parameters; the instantiations are those the wrapper's geometry
//   reaches: C = 1 at KREG 1 and 2, C = 8 at KREG 1 to 32. Each lane
//   keeps a bit mask of its open columns (remaining > 0). Per row, each
//   lane ANDs the row's mask of c > 0 with it into "helps", and the
//   consumers vote: __any_sync for one warp; for eight, the named barrier 1
//   with an OR reduction (bar.red.or.pred 1, 256), which counts the
//   consumer warps only. The decision has no branch: the subtraction is
//   selected by the vote and the open mask is rebuilt every row. A warp
//   issues its integer work at half rate (16 ALU lanes per SMSP), so past
//   64 columns eight warps over the four SMSPs beat one, despite the
//   per-row barrier.
// - Rows go in groups of 4 (at KREG <= 8): the next group's columns are
//   loaded into registers, and this group's masks of c > 0 computed, before
//   the group is decided.
// - The early stop. The cap is checked once a group, and whether any column
//   is still open after the first group and then once every 32 rows (with
//   a second vote); where none is, the walk ends (help needs an open dim,
//   so no later row can be taken). Rows decided past the stop are false,
//   as the scan has them.
// - The take bits of 32 consecutive rows collect in a register; warp 0
//   writes them as 32 bytes at once, and the rows past the stop are
//   zeroed 16 bytes a store.
//
// Routes, chosen by shape in ops/victim_select.py::_launch_shape:
// - "ring" (two stages of two rows fit in the 227 KB, i.e. M <= 7256): a
//   producer warp, one elected thread of it, streams contrib into a ring of
//   S stages of W rows each (W even, a multiple of the group of 4 at
//   KREG <= 8) with 1-D TMA bulk copies
//   (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes).
//   Each stage has a "full" mbarrier (one arrival with the bytes expected)
//   and an "empty" one (one arrival per consumer thread). The first chunk
//   is short, H rows (two groups, or W where a stage holds fewer: the first
//   group is decided after one small copy, and a walk that stops early
//   waits for no whole chunk); chunk
//   c >= 1 holds rows H + (c - 1) W on. A bulk copy needs 16-byte aligned
//   addresses and a size in 16-byte units: contrib is row-major and
//   contiguous, H and W are even and the wrapper hands a 16-byte aligned
//   contrib, so every chunk starts aligned; the last chunk's odd 8 bytes
//   (N and M odd) are copied with a plain load and store. remaining
//   lives in registers (M <= 7256 <= 8 warps x 32 lanes x 32), so the ring
//   has the whole shared budget. At the early stop the consumers raise a
//   flag in shared memory; the producer polls it while it waits for a free
//   stage, issues no more copies, and waits for every copy in flight before
//   it exits. Only the first two chunks go before the walk has left the
//   first, so a walk that stops there waits for few bytes in flight.
// - "wide" (M > 7256: rows too wide for the ring): no producer; 8 consumer
//   warps read each row straight from device memory with __ldg, prefetching
//   the next row's register columns. Columns past the 8192 held in
//   registers live in shared memory while they fit there (M <= 37216),
//   else in the output buffer in device memory.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxConsumers = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxRegCols = 32;  // int64 columns a consumer lane holds in registers
constexpr int kMaxThreads = kWarp * (kMaxConsumers + 1);
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use on Hopper
constexpr int kStopPollNs = 200;  // the producer's longest sleep before it looks for the stop

// rows decided per group: a ring stage holds a whole number of groups
__host__ __device__ constexpr int group_rows(int kreg) { return kreg <= 8 ? 4 : 1; }

struct Header {  // the first bytes of dynamic shared memory
  int stop;  // the walk has ended: issue no more copies
  int pad[kWarp - 1];
  unsigned long long full[kMaxStages];   // stage s holds its chunk
  unsigned long long empty[kMaxStages];  // every consumer has read stage s
};
static_assert(sizeof(Header) == 256, "ops/victim_select.py::_HEADER_BYTES");

struct Params {
  const int64_t* contrib;  // [N,M] ranked candidate rows
  const int64_t* deficit;  // [M]
  uint8_t* selected;       // [N]
  uint8_t* ok;             // [1]
  int64_t* remaining;      // [M]
  int N, M, cap, stages, head_rows, chunk_rows, stage_bytes, ext_in_smem;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// true once the phase of parity ``parity`` has completed
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Waits for the phase unless the walk has stopped first; true if it came.
// A try_wait may sleep for microseconds on a phase that never comes, and
// only the barrier wakes it; so this polls with the non-blocking test_wait
// and sleeps kStopPollNs between polls.
__device__ __forceinline__ bool mbar_wait_or_stop(unsigned long long* bar, uint32_t parity,
                                                  const volatile int* stop) {
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return true;
    if (*stop) return false;
    __nanosleep(kStopPollNs);
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
        "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int64_t wrapping_sub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) - static_cast<uint64_t>(b));
}

// OR of ``v`` over the consumer threads: a warp vote for one warp; for
// eight, the named barrier 1 with an OR reduction, which counts the
// consumer warps only.
template <int C>
__device__ __forceinline__ bool consumers_any(bool v) {
  if constexpr (C == 1) {
    return __any_sync(0xffffffffu, v);
  } else {
    uint32_t out;
    asm volatile(
        "{\n"
        " .reg .pred p, q;\n"
        " setp.ne.u32 q, %1, 0;\n"
        " bar.red.or.pred p, 1, %2, q;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(out)
        : "r"(static_cast<uint32_t>(v)), "n"(C * kWarp));
    return out != 0;
  }
}

template <int KREG>
__device__ __forceinline__ uint32_t positive_mask(const int64_t (&v)[KREG], uint32_t valid) {
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < KREG; ++k) m |= static_cast<uint32_t>(v[k] > 0) << k;
  return m & valid;
}

// Lane t's columns t, t + T, ... below M, as a bit mask over k.
template <int KREG, int T>
__device__ __forceinline__ uint32_t valid_mask(int t, int M) {
  uint32_t valid = 0;
#pragma unroll
  for (int k = 0; k < KREG; ++k) valid |= static_cast<uint32_t>(t + k * T < M) << k;
  return valid;
}

// The producer: one thread issues the ring's copies, chunk c into stage
// c % S once the consumers have released the chunk c - S, until the rows
// run out or the walk stops; then it waits for every copy in flight.
// Chunk 0 holds rows [0, H), chunk c >= 1 rows [H + (c - 1) W, H + c W).
// Chunks 0 and 1 go at once; chunk 2 on waits until the consumers have
// left chunk 0, so that a walk that stops in its first rows leaves two
// copies in flight, not a whole ring.
__device__ void produce(const Params& p, Header& h, unsigned char* ring) {
  const int S = p.stages;
  const int64_t H = p.head_rows, W = p.chunk_rows;
  const int chunks = p.N == 0 ? 0 : p.N <= H ? 1 : static_cast<int>(1 + (p.N - H + W - 1) / W);
  const volatile int* stop = &h.stop;
  int c = 0;
  for (; c < chunks && !*stop; ++c) {
    const int s = c % S;
    if (c >= S || c == 2) {
      const int w = c >= S ? s : 0;  // the stage whose release chunk c waits for
      if (!mbar_wait_or_stop(&h.empty[w], static_cast<uint32_t>(c >= S ? (c / S - 1) & 1 : 0),
                             stop)) {
        break;
      }
    }
    const int64_t r0 = c == 0 ? 0 : H + (c - 1) * W;
    const int64_t rows = p.N - r0 < (c == 0 ? H : W) ? p.N - r0 : (c == 0 ? H : W);
    const uint32_t bytes = static_cast<uint32_t>(rows) * static_cast<uint32_t>(p.M) * 8u;
    const uint32_t bulk = bytes & ~15u;
    unsigned char* dst = ring + static_cast<int64_t>(s) * p.stage_bytes;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(p.contrib + r0 * p.M);
    if (bulk != bytes) {  // the last chunk's odd 8 bytes
      *reinterpret_cast<int64_t*>(dst + bulk) = *reinterpret_cast<const int64_t*>(src + bulk);
    }
    if (bulk != 0) {
      mbar_arrive_tx(&h.full[s], bulk);
      bulk_copy(dst, src, bulk, &h.full[s]);
    } else {
      mbar_arrive(&h.full[s]);
    }
  }
  for (int k = c > S ? c - S : 0; k < c; ++k) {
    mbar_wait(&h.full[k % S], static_cast<uint32_t>((k / S) & 1));
  }
}

// Zeroes selected[from, N) over the T consumer threads, 16 bytes a store
// where the buffer is 16-byte aligned (``from`` is a multiple of 32).
__device__ __forceinline__ void zero_rows(uint8_t* sel, int64_t from, int64_t N, int t, int T) {
  int64_t k = from + t;
  if (reinterpret_cast<uintptr_t>(sel) % 16 == 0) {
    const int64_t hi = N / 16 * 16;
    for (int64_t q = from / 16 + t; q < hi / 16; q += T) {
      reinterpret_cast<uint4*>(sel)[q] = make_uint4(0u, 0u, 0u, 0u);
    }
    k = (hi > from ? hi : from) + t;
  }
  for (; k < N; k += T) sel[k] = 0;
}

template <int KREG, int C, bool RING>
__device__ __forceinline__ void consume(const Params& p, Header& h, unsigned char* dyn) {
  constexpr int T = kWarp * C;
  constexpr int G = group_rows(KREG);
  const int t = threadIdx.x;
  const int lane = t % kWarp;
  const int M = p.M;
  const int N = p.N;
  const int cap = p.cap > 0 ? p.cap : 0x7fffffff;
  const unsigned char* ring = dyn + sizeof(Header);

  const uint32_t valid = valid_mask<KREG, T>(t, M);
  int64_t rem[KREG];
#pragma unroll
  for (int k = 0; k < KREG; ++k) rem[k] = valid >> k & 1u ? p.deficit[t + k * T] : 0;
  uint32_t open = positive_mask<KREG>(rem, valid);

  // columns past the registers' (the wide route only): in shared memory
  // after the header, or in the output buffer
  constexpr int base = T * KREG;
  const bool ext = !RING && M > base;
  int64_t* xs = p.ext_in_smem ? reinterpret_cast<int64_t*>(dyn + sizeof(Header)) : p.remaining;
  const int xoff = p.ext_in_smem ? base : 0;
  if (ext) {
    for (int j = base + t; j < M; j += T) xs[j - xoff] = p.deficit[j];
  }
  auto any_open = [&]() {
    bool o = open != 0;
    if (ext) {
      for (int j = base + t; j < M; j += T) o |= xs[j - xoff] > 0;
    }
    return consumers_any<C>(o);
  };

  int s = 0;                // the ring stage of the group loaded next
  int r = 0;                // its first row in that stage
  int end = p.head_rows;    // the rows that stage's fill holds
  uint32_t phase = 0;       // the parity of the stage's current fill
  // Loads the G rows from row i on (on the ring, the next group of the
  // stream, stepping to the next stage at a stage's end) into v; on the
  // ring a row past N reads the stage's unused bytes and is never decided.
  auto load = [&](int64_t (&v)[G][KREG], int i) {
    const int64_t* row;
    if (RING) {
      if (r == end) {
        mbar_arrive(&h.empty[s]);  // this thread's loads of the stage are done
        r = 0;
        end = p.chunk_rows;
        if (++s == p.stages) {
          s = 0;
          phase ^= 1u;
        }
        mbar_wait(&h.full[s], phase);
      }
      row = reinterpret_cast<const int64_t*>(ring + s * p.stage_bytes) + r * M + t;
      r += G;
    } else {
      row = p.contrib + static_cast<int64_t>(i) * M + t;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < KREG; ++k) {
        const int64_t* q = row + g * M + k * T;
        v[g][k] = !(valid >> k & 1u) ? 0
                  : RING ? *q
                         : static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(q)));
      }
    }
  };

  int i = 0;  // the first row not decided
  int count = 0;
  uint32_t bits = 0;
  bool go = true;  // no early stop yet
  // Decides row ``at`` from its columns v and their mask cpos of c > 0,
  // without a branch: take is a vote, the subtraction is selected by it,
  // and the open mask is rebuilt.
  auto decide = [&](const int64_t (&v)[KREG], uint32_t cpos, int at) {
    const long long* row = reinterpret_cast<const long long*>(p.contrib) +
                           static_cast<int64_t>(at) * M;  // the wide route's extra columns
    bool helps = (cpos & open) != 0;
    if (ext) {
      for (int j = base + t; j < M; j += T) helps |= xs[j - xoff] > 0 && __ldg(row + j) > 0;
    }
    const uint32_t take = consumers_any<C>(helps) && count < cap;
#pragma unroll
    for (int k = 0; k < KREG; ++k) rem[k] = take ? wrapping_sub(rem[k], v[k]) : rem[k];
    open = positive_mask<KREG>(rem, valid);
    if (ext && take) {
      for (int j = base + t; j < M; j += T) {
        xs[j - xoff] = wrapping_sub(xs[j - xoff], static_cast<int64_t>(__ldg(row + j)));
      }
    }
    count += take;
    bits |= take << (at & 31);
  };
  // Decides the whole group at row i from cur, after loading the next
  // whole group into nxt; false once the walk ends or no whole group is
  // left. The early stop is checked once a group for the cap and once
  // every 32 rows for an open dim: past the stop no row can be taken, so
  // the rows decided beyond it are false as well.
  auto step = [&](int64_t (&cur)[G][KREG], int64_t (&nxt)[G][KREG]) -> bool {
    const bool more = N - i >= 2 * G;
    if (more) load(nxt, i + G);
    uint32_t cpos[G];
#pragma unroll
    for (int g = 0; g < G; ++g) cpos[g] = positive_mask<KREG>(cur[g], valid);
#pragma unroll
    for (int g = 0; g < G; ++g) decide(cur[g], cpos[g], i + g);
    i += G;
    go = count < cap;
    if ((i & 31) == 0) {
      if (t < kWarp) p.selected[i - 32 + lane] = (bits >> lane) & 1u;
      bits = 0;
      go = go && any_open();  // no dim open: no later row can help
    }
    return go && more;
  };

  if (N > 0 && RING) mbar_wait(&h.full[0], 0);
  if (N >= G) {
    int64_t a[G][KREG], b[G][KREG];
    load(a, 0);
    // an open dim is looked for once after the first group (a walk whose
    // first take closes every dim stops there), then every 32 rows; the
    // first group is stepped apart so that the loop carries no such test
    if (step(a, b) && (go = any_open())) {
      while (step(b, a) && step(a, b)) {
      }
    }
  }
  if (go && i < N) {  // the last N mod G rows
    int64_t v[G][KREG];
    load(v, i);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (i + g < N) decide(v[g], positive_mask<KREG>(v[g], valid), i + g);
    }
    i = N;
  }
  if (RING && t == 0) *reinterpret_cast<volatile int*>(&h.stop) = 1;

  // rows [i, N) were not walked: false, as the scan gives
  const int g0 = i & ~31;
  if (t < kWarp && g0 + lane < N && g0 < i) p.selected[g0 + lane] = (bits >> lane) & 1u;
  zero_rows(p.selected, g0 < i ? g0 + kWarp : g0, N, t, T);

#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    if (valid >> k & 1u) p.remaining[t + k * T] = rem[k];
  }
  if (ext && p.ext_in_smem) {
    for (int j = base + t; j < M; j += T) p.remaining[j] = xs[j - xoff];
  }
  const bool open_left = any_open();
  if (t == 0) p.ok[0] = !open_left;
}

// Warps: the C consumers, then on the ring the producer.
template <int KREG, int C, bool RING>
__global__ void __launch_bounds__(kMaxThreads, 1) victim_select_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char dyn[];
  Header& h = *reinterpret_cast<Header*>(dyn);
  if (threadIdx.x == 0) {
    h.stop = 0;
    if (RING) {
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(&h.full[s], 1);
        mbar_init(&h.empty[s], kWarp * C);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  if (RING && threadIdx.x >= kWarp * C) {
    if (threadIdx.x == kWarp * C) produce(p, h, dyn + sizeof(Header));
    return;
  }
  consume<KREG, C, RING>(p, h, dyn);
}

// Past 48 KB of dynamic shared memory a kernel must opt in: once per
// instantiation and device, to the whole budget, so that a launch does not
// pay the call.
template <int KREG, int C, bool RING>
cudaError_t launch(const Params& p, int smem, cudaStream_t stream) {
  static std::atomic<uint64_t> opted{0};  // a bit per device
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (!(opted.load(std::memory_order_relaxed) & bit)) {
      e = cudaFuncSetAttribute(victim_select_kernel<KREG, C, RING>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e != cudaSuccess) return e;
      opted.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  victim_select_kernel<KREG, C, RING><<<1, kWarp * (C + RING), smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. The geometry is the wrapper's
// (ops/victim_select.py::_launch_shape), and this entry only checks that
// the kernel can run it: ``consumers`` warps holding ``reg_cols`` columns a
// lane in registers (an instantiation exists for it); on the ring
// (``stages`` > 0) every column in registers, a first chunk of
// ``head_rows`` and then chunks of ``chunk_rows`` rows, both whole row
// groups and even, and the header plus ``stages`` stages of chunk_rows * M
// * 8 bytes rounded up to 128 within ``smem``; on the wide route (stages 0)
// 8 warps of 32 register columns, and remaining's extra columns in
// shared memory when ``smem`` holds them. A geometry the kernel does not
// take is refused with cudaErrorInvalidValue. Returns the cudaError_t of
// the launch (0 = cudaSuccess); the kernel runs asynchronously on
// ``stream``.
extern "C" int kt_victim_select(const int64_t* contrib, const int64_t* deficit,
                                uint8_t* selected, uint8_t* ok, int64_t* remaining,
                                int N, int M, int cap, int consumers, int reg_cols, int stages,
                                int head_rows, int chunk_rows, int smem, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N < 0 || M < 1 || smem < static_cast<int>(sizeof(Header)) || smem > kSmemMax) {
    return invalid;
  }
  Params p{contrib, deficit, selected, ok, remaining, N, M, cap, stages, head_rows, chunk_rows,
           0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages == 0) {  // the wide route: 8 warps, 32 register columns a lane
    if (consumers != kMaxConsumers || reg_cols != kMaxRegCols) return invalid;
    const int64_t ext = static_cast<int64_t>(M) - int64_t{kWarp} * kMaxConsumers * kMaxRegCols;
    p.ext_in_smem = ext > 0 && static_cast<int64_t>(sizeof(Header)) + ext * 8 <= smem;
    return static_cast<int>(launch<kMaxRegCols, kMaxConsumers, false>(p, smem, s));
  }
  const int64_t stage = (static_cast<int64_t>(chunk_rows) * M * 8 + 127) / 128 * 128;
  const int unit = group_rows(reg_cols) < 2 ? 2 : group_rows(reg_cols);
  if (stages < 2 || stages > kMaxStages || chunk_rows < unit || chunk_rows % unit != 0 ||
      head_rows < unit || head_rows % unit != 0 || head_rows > chunk_rows ||
      int64_t{kWarp} * consumers * reg_cols < M ||
      reinterpret_cast<uintptr_t>(contrib) % 16 != 0 ||
      static_cast<int64_t>(sizeof(Header)) + stages * stage > smem) {
    return invalid;
  }
  p.stage_bytes = static_cast<int>(stage);
  if (consumers == 1) {
    switch (reg_cols) {
      case 1: return static_cast<int>(launch<1, 1, true>(p, smem, s));
      case 2: return static_cast<int>(launch<2, 1, true>(p, smem, s));
      default: return invalid;
    }
  }
  if (consumers != kMaxConsumers) return invalid;
  switch (reg_cols) {
    case 1: return static_cast<int>(launch<1, kMaxConsumers, true>(p, smem, s));
    case 2: return static_cast<int>(launch<2, kMaxConsumers, true>(p, smem, s));
    case 4: return static_cast<int>(launch<4, kMaxConsumers, true>(p, smem, s));
    case 8: return static_cast<int>(launch<8, kMaxConsumers, true>(p, smem, s));
    case 16: return static_cast<int>(launch<16, kMaxConsumers, true>(p, smem, s));
    case 32: return static_cast<int>(launch<32, kMaxConsumers, true>(p, smem, s));
    default: return invalid;
  }
}
