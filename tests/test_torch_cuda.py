"""Card-only tests of the port (marker ``cuda``): they skip without a CUDA
device. This file imports nothing of JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- the dense CUDA kernel ≡ its plain version (ragged shapes, all four
  (onEqual, step-3 onEqual) variants, both R routes of the kernel: the
  throttle column in registers up to R = 16, in shared memory past it;
  the int64 extremes), each launch counted once;
- ``check_dense`` enqueues the output's ``torch.empty`` and nothing else
  besides its one launch;
- a launch the card refuses raises ``KernelLaunchError``;
- the main path on ``device="cuda"`` ≡ the same stack on ``device="cpu"``
  (``pre_filter_batch`` verdicts and routes), with the kernel launched;
- the tick's torch functions (override resolution, the aggregations and
  scatters, both step forms) on CUDA tensors ≡ on CPU tensors at a mid
  shape, and ``full_tick_sharded`` on ``device="cuda"`` ≡ ``"cpu"``, also
  on (2, 2) and (1, 4) grids of four slots on the card, and the ring of
  four slots on the card ≡ on the CPU;
- the victim_select kernel ≡ its plain version (the ring and wide
  routes, odd M, chunk edges, stops mid-chunk, negative contributions, the
  int64 extremes, N = 0, caps), a refused launch raises, and
  ``gang_check_groups`` on ``device="cuda"`` ≡ ``"cpu"``;
- the check_gather kernels ≡ their plain versions: the pack's records
  byte for byte ≡ ``pack_gather_rows_reference``'s, padding included, and
  the check ≡ ``check_gather_reference`` (K in {4, 32, 64, 2048} ×
  R in {3, 8, 16, 20}, R in {33, 40}, all four variants, both forms, int64
  extremes, pads, invalid rows and pods, cols >= T); a refused pack or
  check launch raises, and the wrapper enqueues the outputs' and the
  records' ``torch.empty`` and nothing else besides its two launches.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kube_throttler_tpu_torch.ops import check_dense as cd
from kube_throttler_tpu_torch.ops.fastcheck import precompute_check_state
from kube_throttler_tpu_torch.ops.schema import (
    check_precomp_from_arrays,
    pod_batch_from_arrays,
    throttle_state_from_arrays,
)

# by its own name (pytest puts tests/ on the path): a package named ``tests``
# installed elsewhere would shadow this directory
from torch_gather_cases import EXTREMES, WIDE, gather_arrays, gather_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_case(rng, P, T, R, device):
    """Seeded state/pods/mask arrays through the carry-across; odd dims
    carry values past 2^32."""
    scale = np.where(np.arange(R) % 2 == 1, 2**33, 1).astype(np.int64)
    state = dict(
        valid=rng.random(T) < 0.9,
        thr_cnt=rng.integers(0, 60, T), thr_cnt_present=rng.random(T) < 0.5,
        thr_req=rng.integers(0, 2000, (T, R)) * scale, thr_req_present=rng.random((T, R)) < 0.7,
        used_cnt=rng.integers(0, 60, T), used_cnt_present=rng.random(T) < 0.8,
        used_req=rng.integers(0, 2200, (T, R)) * scale, used_req_present=rng.random((T, R)) < 0.8,
        res_cnt=rng.integers(0, 3, T), res_cnt_present=rng.random(T) < 0.3,
        res_req=rng.integers(0, 200, (T, R)) * scale, res_req_present=rng.random((T, R)) < 0.3,
        st_cnt_throttled=rng.random(T) < 0.03, st_req_throttled=rng.random((T, R)) < 0.05,
        st_req_flag_present=rng.random((T, R)) < 0.5,
    )
    pods = dict(valid=rng.random(P) < 0.95, req=rng.integers(0, 1000, (P, R)) * scale,
                req_present=rng.random((P, R)) < 0.7)
    pre = precompute_check_state(throttle_state_from_arrays(state, device=device))
    return pre, pod_batch_from_arrays(pods, device=device), \
        torch.from_numpy(rng.random((P, T)) < 0.5).to(device)


def _extremes_case(device):
    n = len(EXTREMES)
    v = np.array(EXTREMES, dtype=np.int64)[:, None]
    t, f, fr = np.ones(n, bool), np.zeros(n, bool), np.zeros((n, 1), bool)
    pre = check_precomp_from_arrays(dict(
        valid=t, thr_req=v, thr_req_present=np.ones((n, 1), bool), exceeds_cnt=f,
        st_cnt=f, st_req=fr, sat_cnt_ge=f, sat_cnt_gt=f, sat_req_ge=fr, sat_req_gt=fr,
        resid=v.copy(), over_cnt_ge=f, over_cnt_gt=f,
    ), device=device)
    pods = pod_batch_from_arrays(
        dict(valid=t, req=v.copy(), req_present=np.ones((n, 1), bool)), device=device
    )
    return pre, pods, torch.ones((n, n), dtype=torch.bool, device=device)


VARIANTS = [(False, True), (True, True), (False, False), (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("on_equal,step3", VARIANTS)
def test_kernel_matches_plain(card, on_equal, step3):
    """Ragged shapes; R = 16 is the widest register route, R = 20 and
    R = 100 take the shared-memory route (R = 100 on a narrowed tile past
    48 KB of shared memory)."""
    rng = np.random.default_rng(1)
    shapes = ((37, 19, 3), (1, 33, 8), (300, 700, 8), (300, 70, 16), (300, 700, 20),
              (64, 300, 100))
    cases = [_extremes_case(card)] + [_random_case(rng, P, T, R, card) for P, T, R in shapes]
    for pre, pods, mask in cases:
        before = cd.launches
        got = cd.check_dense(pre, pods, mask, on_equal=on_equal, step3_on_equal=step3)
        torch.cuda.synchronize()
        assert cd.launches == before + 1
        want = cd.check_dense_reference(pre, pods, mask, on_equal, step3)
        assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.cuda
def test_check_dense_enqueues_one_kernel(card):
    """Besides its launch, the wrapper runs no torch op on the card but the
    output's allocation: the variant selection happens in the kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    pre, pods, mask = _random_case(np.random.default_rng(3), 300, 16, 8, card)
    cd.check_dense(pre, pods, mask)  # build and load outside the record
    before = cd.launches
    with Record() as rec:
        got = cd.check_dense(pre, pods, mask, on_equal=True, step3_on_equal=False)
    assert rec.ops == ["aten.empty.memory_format"]
    assert cd.launches == before + 1
    assert torch.equal(got, cd.check_dense_reference(pre, pods, mask, True, False))


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(card):
    pre, pods, mask = _random_case(np.random.default_rng(2), 8, 8, 2, card)
    with pytest.raises(ValueError, match="contiguous"):
        cd.check_dense(pre, pods, mask.t().contiguous().t())
    with pytest.raises(TypeError, match="dtype"):
        cd.check_dense(pre, pods, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="is on"):
        cd.check_dense(dataclasses.replace(pre, resid=pre.resid.cpu()), pods, mask)


@pytest.mark.cuda
def test_kernel_launch_failure_raises(card, monkeypatch):
    """A launch the card refuses (2048 threads per block, through the
    geometry hook) raises KernelLaunchError and counts no launch."""
    pre, pods, mask = _random_case(np.random.default_rng(4), 64, 40, 2, card)
    monkeypatch.setattr(cd, "_launch_shape",
                        lambda P, T, R: cd.LaunchShape((32, 64), (2, 1), 64, 8, 0))
    before = cd.launches
    with pytest.raises(cd.KernelLaunchError, match="cudaError"):
        cd.check_dense(pre, pods, mask)
    assert cd.launches == before


def _stack(device):
    """A seeded served stack: 2,000 pods, 200 Throttles (the sparse route)
    and 4 ClusterThrottles (the dense route), reconciled and prewarmed."""
    import random

    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.api.types import (
        ClusterThrottle, ClusterThrottleSelector, ClusterThrottleSelectorTerm,
        ClusterThrottleSpec, LabelSelector, ResourceAmount, Throttle,
        ThrottleSelector, ThrottleSelectorTerm, ThrottleSpec,
    )
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    rng = random.Random(3)
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store, device=device,
    )
    store.create_namespace(Namespace("default"))
    for i in range(200):
        store.create_throttle(Throttle(name=f"t{i}", spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=rng.randrange(10, 80)),
            selector=ThrottleSelector(selector_terms=(ThrottleSelectorTerm(
                LabelSelector(match_labels={"grp": f"g{i % 50}"})),)))))
    for j in range(4):
        store.create_cluster_throttle(ClusterThrottle(name=f"c{j}", spec=ClusterThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(requests={"cpu": f"{(j + 1) * 60}"}),
            selector=ClusterThrottleSelector(selector_terms=(ClusterThrottleSelectorTerm(
                pod_selector=LabelSelector(match_labels={"mod": f"m{j}"})),)))))
    for k in range(2000):
        g = rng.randrange(50)
        store.create_pod(make_pod(
            f"p{k}", labels={"grp": f"g{g}", "mod": f"m{g % 4}"},
            requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
            node_name="node-1" if k % 3 else "", phase="Running" if k % 3 else "Pending",
        ))
    plugin.run_pending_once()
    plugin.device_manager.prewarm()
    return plugin


@pytest.mark.cuda
def test_main_path_on_card_matches_cpu(card):
    """pre_filter_batch on device='cuda' ≡ device='cpu' on one seeded store;
    the ClusterThrottle kind takes the dense route through the kernel."""
    want = _stack("cpu")
    got = _stack(card)
    for plugin in (want, got):
        plugin.verdict_cache = None  # the batch kernels, not the dedupe shortcut
    before = cd.launches
    out = got.pre_filter_batch()
    assert cd.launches > before
    assert got.device_manager.last_batch_routes == {"throttle": "sparse", "clusterthrottle": "dense"}
    assert out == want.pre_filter_batch()
    assert set(out["schedulable"].values()) == {True, False}
    assert got.device_manager.breaker_state() == "closed"
    got.stop()
    want.stop()


def _tick_inputs(device, P=4096, T=512, R=8, K=16, O=4, seed=5):
    """Seeded inputs of the tick's functions at a mid shape, on
    ``device``: the schedule (through the carry-across), pods, mask and its
    [P,K] cols, counted, reservations, validity and ``now``."""
    from kube_throttler_tpu_torch.ops.schema import override_schedule_from_arrays

    rng = np.random.default_rng(seed)
    now = 1_750_000_000 * 10**9
    big = np.where(np.arange(R) % 2 == 1, 2**30, 1).astype(np.int64)
    sched = override_schedule_from_arrays(dict(
        ov_valid=rng.random((T, O)) < 0.6,
        ov_begin=now + rng.integers(-3600, 3600, (T, O)) * 10**9,
        ov_end=now + rng.integers(-600, 7200, (T, O)) * 10**9,
        ov_cnt=rng.integers(0, 40, (T, O)), ov_cnt_present=rng.random((T, O)) < 0.5,
        ov_req=rng.integers(0, 4000, (T, O, R)) * big, ov_req_present=rng.random((T, O, R)) < 0.5,
        spec_cnt=rng.integers(0, 40, T), spec_cnt_present=rng.random(T) < 0.5,
        spec_req=rng.integers(0, 4000, (T, R)) * big, spec_req_present=rng.random((T, R)) < 0.6,
    ), device=device)
    pods = pod_batch_from_arrays(dict(
        valid=rng.random(P) < 0.9, req=rng.integers(0, 300, (P, R)) * big,
        req_present=rng.random((P, R)) < 0.7,
    ), device=device)
    cols = np.full((P, K), -1, dtype=np.int32)
    n = rng.integers(0, K + 1, P)
    for p in range(P):
        cols[p, : n[p]] = np.sort(rng.choice(T, n[p], replace=False))
    mask = np.zeros((P, T), dtype=bool)
    rows = np.repeat(np.arange(P), K).reshape(P, K)
    mask[rows[cols >= 0], cols[cols >= 0]] = True
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    counted = t(rng.random(P) < 0.7) & pods.valid
    res = (t(rng.integers(0, 3, T)), t(rng.random(T) < 0.3),
           t(rng.integers(0, 300, (T, R)) * big), t(rng.random((T, R)) < 0.3))
    thr_valid = t(rng.random(T) < 0.95)
    now_ns = torch.tensor(now, dtype=torch.int64, device=device)
    return sched, pods, t(mask), t(cols), counted, res, thr_valid, now_ns, rng


@pytest.mark.cuda
def test_tick_functions_on_card_match_cpu(card):
    """Each torch function of the tick on CUDA tensors ≡ the same on CPU
    tensors, bit for bit, at 4096 pods × 512 throttles × 8 dims (K = 16):
    the int64 scatters and column sums are exact in any order."""
    from kube_throttler_tpu_torch.ops import aggregate as agg
    from kube_throttler_tpu_torch.ops.overrides import calculate_thresholds
    from kube_throttler_tpu_torch.parallel import sharded

    def run(device):
        sched, pods, mask, cols, counted, res, thr_valid, now_ns, rng = _tick_inputs(device)
        T, R = sched.spec_req.shape
        t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
        base = (t(rng.integers(0, 10**6, T)), t(rng.integers(0, 2**50, (T, R))),
                t(rng.integers(0, 100, (T, R)).astype(np.int32)))
        ids = rng.integers(-1, T + 4, (512, 8)).astype(np.int32)  # JAX-style pads
        deltas = (t(ids), t(rng.choice([-1, 0, 1], (512, 8))), t(rng.integers(0, 2**40, (512, R))),
                  t(rng.random((512, R)) < 0.5))
        cols_k = t(np.r_[rng.integers(0, T, 60), [T, T + 1, -1, 3]].astype(np.int32))
        out = {"thresholds": calculate_thresholds(sched, now_ns),
               "aggregate_used": agg.aggregate_used(pods, mask, counted),
               "deltas": agg.apply_pod_deltas_batched(*base, *deltas),
               "rebase_cols": agg.rebase_cols(*base, pods, mask, counted, cols_k),
               "aggregate_cols": agg.aggregate_cols(pods, mask, counted, cols_k),
               "used_from_cols": sharded.used_from_cols(pods, cols, counted, T)}
        before = cd.launches
        for on_equal, step3 in VARIANTS:
            out[f"step{on_equal}{step3}"] = sharded.full_update_step(
                sched, pods, mask, counted, *res, thr_valid, now_ns,
                on_equal=on_equal, step3_on_equal=step3)
            out[f"gather{on_equal}{step3}"] = sharded.full_update_step_gather(
                sched, pods, cols, counted, *res, thr_valid, now_ns,
                on_equal=on_equal, step3_on_equal=step3)
        return out, cd.launches - before

    got, launched = run(card)
    want, _ = run("cpu")
    assert launched == len(VARIANTS)
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g.device.type == "cuda" and g.dtype == w.dtype, name
            assert torch.equal(g.cpu(), w), name
        if name.startswith("step"):
            gather = got["gather" + name[4:]]
            assert all(torch.equal(a, b) for a, b in zip(got[name], gather)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_tick_on_card_matches_cpu(card, dense):
    """full_tick_sharded on device='cuda' ≡ device='cpu' on one seeded
    store, the kernel launched on the dense route."""
    from kube_throttler_tpu_torch.parallel import make_mesh

    want, got = _stack("cpu"), _stack(card)
    before = cd.launches
    out = got.device_manager.full_tick_sharded(make_mesh(device=card), dense_mesh=dense)
    assert cd.launches == before + (2 if dense else 1)
    ref = want.device_manager.full_tick_sharded(make_mesh(device="cpu"), dense_mesh=dense)
    for kind in ("throttle", "clusterthrottle"):
        for g, w in zip(out[kind], ref[kind]):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and np.array_equal(g, w), kind
            else:
                assert g == w, kind
    assert got.full_tick_sharded() == want.full_tick_sharded()
    got.stop()
    want.stop()


@pytest.mark.cuda
def test_grid_ticks_and_ring_on_card_match_cpu(card):
    """The (2, 2) and (1, 4) grid ticks with all four slots on the card ≡
    the same grids of CPU slots on one seeded store, each slot launching
    its tile's kernels; the ring of 4 slots on the card over the tick's
    dense operands ≡ the ring on the CPU, check_dense once per hop per
    slot."""
    from datetime import datetime, timezone

    from kube_throttler_tpu_torch.ops import check_gather as cg
    from kube_throttler_tpu_torch.parallel import make_mesh, make_ring_mesh, ring_full_update

    now = datetime.now(timezone.utc)
    want, got = _stack("cpu"), _stack(card)
    for shape in ((2, 2), (1, 4)):
        before = (cd.launches, cg.launches, cg.pack_launches)
        out = got.device_manager.full_tick_sharded(make_mesh(4, shape, devices=[card] * 4),
                                                   now=now)
        assert (cd.launches, cg.launches, cg.pack_launches) == tuple(b + 4 for b in before)
        assert got.device_manager.last_tick["throttle"]["route"] == "sparse"
        ref = want.device_manager.full_tick_sharded(make_mesh(4, shape, device="cpu"), now=now)
        for kind in ("throttle", "clusterthrottle"):
            for g, w in zip(out[kind], ref[kind]):
                if isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype and np.array_equal(g, w), (shape, kind)
                else:
                    assert g == w, (shape, kind)
    got.stop()
    want.stop()

    def ring(device, devices):
        sched, pods, mask, _, counted, res, thr_valid, now_ns, _ = _tick_inputs(device)
        return ring_full_update(make_ring_mesh(4, device=device, devices=devices))(
            sched, pods, mask, counted, *res, thr_valid, now_ns)

    before = cd.launches
    on_card = ring(card, [card] * 4)
    assert cd.launches == before + 16
    for g, w in zip(on_card, ring("cpu", None)):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g.cpu(), w)


def _victim_seeded(rng, N, M):
    contrib = rng.integers(0, 2**40, (N, M), dtype=np.int64)
    contrib[rng.random((N, M)) < 0.9] = 0
    deficit = (contrib.sum(0) * rng.uniform(0.2, 0.8, M)).astype(np.int64)
    return contrib, deficit


def _ring_place(shape, row):
    """(offset of ``row`` in its ring chunk, that chunk's rows, offset in
    its row group): the first chunk holds ``head_rows`` rows, every later
    one ``chunk_rows``."""
    H, W = shape.head_rows, shape.chunk_rows
    off, rows = (row, H) if row < H else ((row - H) % W, W)
    return off, rows, row % shape.group_rows


def _mid_row(shape, chunk):
    """The first row past the middle of ring chunk ``chunk`` (>= 1) that is
    neither the first nor the last of its chunk or of its row group."""
    W = shape.chunk_rows
    for off in range(W // 2, W - 1):
        row = shape.head_rows + (chunk - 1) * W + off
        if 0 < row % shape.group_rows < shape.group_rows - 1:
            return row
    raise AssertionError(f"no row inside chunk {chunk} and a group of {shape}")


def _victim_problems(case):
    """[(contrib, deficit, caps)] of one card case, seeded with numpy."""
    from kube_throttler_tpu_torch.ops import victim_select as vsel

    rng = np.random.default_rng(6)
    if case == "seeded":  # one row, a met deficit, M = 2500, the wide route
        out = []
        for N, M in ((1, 1), (37, 5), (3, 7), (500, 64), (300, 2500), (40, 30000)):
            contrib, deficit = _victim_seeded(rng, N, M)
            if N == 3:
                deficit[:] = -1
            out.append((contrib, deficit, sorted({0, 1, N // 2})))
        return out
    if case == "odd_m":  # rows of 8 * M bytes, the last chunk's odd 8 bytes (N, M odd)
        return [(*_victim_seeded(rng, N, M), [0, N // 3])
                for N, M in ((1001, 5), (999, 7), (2001, 33), (301, 2500))]
    if case == "chunk_edges":  # N ends inside a ring chunk and inside a row group
        shape = vsel._launch_shape(256)
        H, W = shape.head_rows, shape.chunk_rows
        ns = (H // 2 + 1, H + 5, H + 7, H + 3 * W + 3, H + 57 * W + 9)
        for N in ns:
            off, rows, in_group = _ring_place(shape, N - 1)
            assert off < rows - 1 and in_group < shape.group_rows - 1, (N, shape)
        return [(*_victim_seeded(rng, N, 256), [0, 5]) for N in ns]
    if case == "stops_mid_chunk":
        # every row helps dim 0, so the cap stops the walk inside a ring
        # chunk and inside a row group, with the producer stages ahead;
        # then a deficit that closes at such a row
        N, M = 4096, 256
        shape = vsel._launch_shape(M)
        stops = [_mid_row(shape, chunk) for chunk in (11, 51, 15)]
        for row in stops:
            off, rows, in_group = _ring_place(shape, row)
            assert 0 < off < rows - 1 and 0 < in_group < shape.group_rows - 1, (row, shape)
            assert row // shape.chunk_rows > shape.stages  # the ring has wrapped
        contrib = np.zeros((N, M), dtype=np.int64)
        contrib[:, 0] = 1
        contrib[:, 1:] = rng.integers(0, 6, (N, M - 1))  # met dims stay met
        deficit = np.full(M, -1, dtype=np.int64)
        deficit[0] = 10**6
        closing = deficit.copy()
        closing[0] = stops[2] + 1  # one take a row: the last is row stops[2]
        return [(contrib, deficit, [stops[0] + 1, stops[1] + 1]), (contrib, closing, [0])]
    if case == "negative":  # negative contributions reopen met dims
        out = []
        for N, M in ((2000, 8), (3000, 256), (500, 2500)):
            contrib = rng.integers(-(2**40), 2**40, (N, M), dtype=np.int64)
            contrib[rng.random((N, M)) < 0.7] = 0
            deficit = rng.integers(0, 2**41, M, dtype=np.int64)
            out.append((contrib, deficit, [0, N // 4]))
        return out
    if case == "extremes":  # the int64 extremes: the subtraction wraps
        ext = np.array(EXTREMES, dtype=np.int64)
        out = []
        for N, M in ((600, 13), (300, 256)):
            contrib = rng.choice(ext, (N, M))
            contrib[rng.random((N, M)) < 0.5] = 0
            out.append((contrib, rng.choice(ext, M), [0, 7]))
        return out
    if case == "wide":  # rows past the ring: remaining beside the registers
        return [(*_victim_seeded(rng, N, M), [0, 3])
                for N, M in ((64, 7257), (50, 30000), (6, 40000), (2, 10**6))]
    assert case == "empty"  # N = 0
    return [(np.zeros((0, M), dtype=np.int64), np.ones(M, dtype=np.int64), [0, 1])
            for M in (4, 256, 30000)]


VICTIM_CASES = ("seeded", "odd_m", "chunk_edges", "stops_mid_chunk", "negative", "extremes",
                "wide", "empty")


@pytest.mark.cuda
@pytest.mark.parametrize("case", VICTIM_CASES)
def test_victim_kernel_matches_plain(card, case):
    """victim_select's kernel ≡ its plain version on the card, bit for bit,
    each launch counted once: one row, a deficit already met, more dims
    than threads (M = 2500), and remaining held beside the registers
    (M = 30000, past the ring); odd M and the last chunk's odd 8 bytes;
    N off the chunk; a cap and a closing deficit that stop the walk
    mid-chunk; negative contributions; the int64 extremes; N = 0."""
    from kube_throttler_tpu_torch.ops import victim_select as vsel

    for contrib, deficit, caps in _victim_problems(case):
        N, M = contrib.shape
        c, d = torch.from_numpy(contrib).to(card), torch.from_numpy(deficit).to(card)
        for cap in caps:
            before = vsel.launches
            got = vsel.victim_select(c, d, cap)
            torch.cuda.synchronize()
            assert vsel.launches == before + 1
            want = vsel.victim_select_reference(c, d, cap)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (case, N, M, cap)


@pytest.mark.cuda
def test_victim_kernel_takes_an_unaligned_view(card):
    """A contiguous view 8 bytes off a 16-byte boundary (odd M, from row 1)
    still gives the plain version's answer: the wrapper realigns it for the
    bulk copies."""
    from kube_throttler_tpu_torch.ops import victim_select as vsel

    contrib, deficit = _victim_seeded(np.random.default_rng(7), 501, 7)
    c = torch.from_numpy(contrib).to(card)[1:]
    assert c.data_ptr() % 16 == 8 and c.is_contiguous()
    d = torch.from_numpy(deficit).to(card)
    got = vsel.victim_select(c, d, 0)
    want = vsel.victim_select_reference(c, d, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("refused", [
    {"consumers": 64},                  # 2048 threads: past the kernel's 8 consumer warps
    {"smem": 300_000},                  # past the 227 KB a block may use
    {"chunk_rows": 3},                  # an odd chunk: a copy off the 16-byte grid
    {"stages": 1},                      # a ring of one stage
    {"reg_cols": 4},                    # one warp of 4 register columns: not instantiated
    {"head_rows": 6},                   # a first chunk of one and a half row groups
])
def test_victim_kernel_launch_failure_raises(card, monkeypatch, refused):
    """A launch the card or the kernel's entry refuses (a geometry set
    through the hook) raises KernelLaunchError and counts no launch."""
    from kube_throttler_tpu_torch.ops import victim_select as vsel

    real = vsel._launch_shape
    monkeypatch.setattr(vsel, "_launch_shape",
                        lambda M: real(M)._replace(**refused))
    c = torch.ones((4, 4), dtype=torch.int64, device=card)
    before = vsel.launches
    with pytest.raises(cd.KernelLaunchError, match="cudaError"):
        vsel.victim_select(c, torch.ones(4, dtype=torch.int64, device=card))
    assert vsel.launches == before


@pytest.mark.cuda
def test_gang_check_groups_on_card_matches_cpu(card):
    """gang_check_groups on device='cuda' ≡ device='cpu' on one seeded
    store: stored and unstored members, two accel classes."""
    import random

    from kube_throttler_tpu_torch.api.pod import make_pod

    want, got = _stack("cpu"), _stack(card)
    rng = random.Random(8)
    groups = []
    for k in range(40):
        g, cls = rng.randrange(50), [None, "v5e", None, "v5p"][k % 4]
        members = [make_pod(f"gang{k}-{r}", labels={"grp": f"g{g}", "mod": f"m{g % 4}"},
                            requests={"cpu": f"{rng.randrange(1, 30) * 10}m"}, group=f"gang{k}",
                            group_size=4, accel_class=cls) for r in range(4)]
        groups.append((f"default/gang{k}", members, cls))
    out = got.device_manager.gang_check_groups(groups)
    assert out == want.device_manager.gang_check_groups(groups)
    assert {v["ok"] for v in out.values()} == {True, False}
    assert got.device_manager.breaker_state() == "closed"
    got.stop()
    want.stop()


def _gather_case(rng, P, K, T, R, device, extremes=False):
    """``gather_arrays`` on ``device``, through the carry-across."""
    state, pods, cols = gather_arrays(rng, P, K, T, R, extremes)
    return (throttle_state_from_arrays(state, device=device),
            pod_batch_from_arrays(pods, device=device), torch.from_numpy(cols).to(device))


def _assert_gather_kernel_matches_plain(state, pods, cols, on_equal, step3):
    from kube_throttler_tpu_torch.ops import check_gather as cg

    before, packs = cg.launches, cg.pack_launches
    got = cg.check_gather(state, pods, cols, on_equal, step3, statuses=True)
    counts, sched = cg.check_gather(state, pods, cols, on_equal, step3)
    packed = cg.pack_gather_rows(state)
    torch.cuda.synchronize()
    assert cg.launches == before + 2 and cg.pack_launches == packs + 3
    assert torch.equal(packed, cg.pack_gather_rows_reference(state))
    want = cg.check_gather_reference(state, pods, cols, on_equal, step3, statuses=True)
    w_counts, w_sched = cg.check_gather_reference(state, pods, cols, on_equal, step3)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert counts.dtype == torch.int32 and torch.equal(counts, w_counts)
    assert sched.dtype == torch.bool and torch.equal(sched, w_sched)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 32, 64, 2048])
@pytest.mark.parametrize("R", [3, 8, 16, 20])
def test_gather_kernel_matches_plain(card, K, R):
    (P, K, T, R), seed = gather_cell(K, R, card=True)
    case = _gather_case(np.random.default_rng(seed), P, K, T, R, card)
    for on_equal, step3 in VARIANTS:
        _assert_gather_kernel_matches_plain(*case, on_equal, step3)


@pytest.mark.cuda
@pytest.mark.parametrize("K,R", WIDE)
def test_gather_kernel_matches_plain_past_32_dims(card, K, R):
    """R > 32: two mask words a record, pods requesting dims on both
    sides of 32."""
    (P, K, T, R), seed = gather_cell(K, R, card=True)
    case = _gather_case(np.random.default_rng(seed), P, K, T, R, card)
    for on_equal, step3 in VARIANTS:
        _assert_gather_kernel_matches_plain(*case, on_equal, step3)


@pytest.mark.cuda
@pytest.mark.parametrize("R,extremes", [(3, True), (8, False), (33, True), (40, False)])
def test_gather_pack_writes_every_byte(card, R, extremes):
    """The pack kernel's records ≡ ``pack_gather_rows_reference``'s, byte
    for byte, into memory the allocator hands back poisoned: every pad word
    and every mask bit past R is written."""
    from kube_throttler_tpu_torch.ops import check_gather as cg

    state, _, _ = _gather_case(np.random.default_rng(R), 2, 4, 5000, R, card,
                               extremes=extremes)
    shape = (5000, cg.record_layout(R).words)
    poison = torch.full(shape, -0x5A5A5A5A5A5A5A5B, dtype=torch.int64, device=card)
    del poison  # the caching allocator hands this block to the pack's buffer
    packed = cg.pack_gather_rows(state)
    torch.cuda.synchronize()
    want = cg.pack_gather_rows_reference(state)
    assert packed.dtype == torch.int64 and tuple(packed.shape) == shape
    assert torch.equal(packed.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_gather_kernel_extremes_and_edges(card):
    """int64 extremes (used + res + pod wraps), a pod whose every slot is a
    pad, and a single-slot, single-pod call."""
    rng = np.random.default_rng(9)
    cases = [_gather_case(rng, 500, 16, 40, 3, card, extremes=True),
             _gather_case(rng, 1, 1, 1, 1, card)]
    state, pods, cols = _gather_case(rng, 33, 5, 9, 2, card)
    cols[0] = -1
    cases.append((state, pods, cols))
    for case in cases:
        for on_equal, step3 in VARIANTS:
            _assert_gather_kernel_matches_plain(*case, on_equal, step3)


@pytest.mark.cuda
def test_gather_kernel_launch_failure_raises(card, monkeypatch):
    """A launch the kernel's entry refuses (2048 threads, through the
    geometry hook: a nonzero cudaError_t) raises KernelLaunchError and
    counts no launch."""
    from kube_throttler_tpu_torch.ops import check_gather as cg

    state, pods, cols = _gather_case(np.random.default_rng(4), 64, 8, 40, 2, card)
    real = cg._launch_shape
    monkeypatch.setattr(cg, "_launch_shape", lambda *a: real(*a)._replace(threads=2048))
    before = cg.launches
    with pytest.raises(cd.KernelLaunchError, match="cudaError"):
        cg.check_gather(state, pods, cols)
    assert cg.launches == before


@pytest.mark.cuda
def test_gather_pack_launch_failure_raises(card, monkeypatch):
    """A pack launch its entry refuses (2048 threads a block) raises
    KernelLaunchError before the check is launched, and counts neither."""
    from kube_throttler_tpu_torch.ops import check_gather as cg

    state, pods, cols = _gather_case(np.random.default_rng(4), 64, 8, 40, 2, card)
    real = cg._launch_shape
    monkeypatch.setattr(cg, "_launch_shape", lambda *a: real(*a)._replace(pack_threads=2048))
    before, packs = cg.launches, cg.pack_launches
    for call in (lambda: cg.check_gather(state, pods, cols, statuses=True),
                 lambda: cg.pack_gather_rows(state)):
        with pytest.raises(cd.KernelLaunchError, match="pack launch failed: cudaError"):
            call()
    assert cg.launches == before and cg.pack_launches == packs


@pytest.mark.cuda
@pytest.mark.parametrize("statuses", [False, True])
def test_check_gather_enqueues_one_kernel(card, statuses):
    """Besides its two launches, the wrapper runs no torch op on the card
    but the outputs' and the records' allocations: the variant, the form
    and used + reserved are the kernels'."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from kube_throttler_tpu_torch.ops import check_gather as cg

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    state, pods, cols = _gather_case(np.random.default_rng(3), 300, 32, 100, 8, card)
    cg.check_gather(state, pods, cols)  # build and load outside the record
    before, packs = cg.launches, cg.pack_launches
    with Record() as rec:
        got = cg.check_gather(state, pods, cols, True, False, statuses=statuses)
    assert rec.ops == ["aten.empty.memory_format"] * (2 if statuses else 3)
    assert cg.launches == before + 1 and cg.pack_launches == packs + 1
    want = cg.check_gather_reference(state, pods, cols, True, False, statuses=statuses)
    for g, w in zip((got,) if statuses else got, (want,) if statuses else want):
        assert torch.equal(g, w)
