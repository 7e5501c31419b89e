"""The sparse gather check of the port (``ops/check_gather.py``) on the CPU.

- Both plain versions ≡ the JAX package's ``check_pods_gather`` and
  ``check_pods_gather_statuses``, bit for bit and dtype for dtype: the one
  over the state's planes, and the one over packed records
  (``check_packed_reference`` of ``pack_gather_rows_reference``), on
  seeded raw arrays (``tests/torch_gather_cases.py``, which the card's
  tests and ``chip_smoke.py`` share): K in {4, 32, 64, 2048} × R in {3, 8, 16, 20}
  and R in {33, 40}, all four
  (onEqual, step-3 onEqual) variants; -1 pads, invalid throttle rows and
  invalid pods; int64 extremes where ``used + res + pod`` wraps; cols equal
  to T and T + 3 (fault (h): JAX clamps them to row T - 1, where torch
  raised); a P-chunked plain version (``KT_GATHER_CHUNK_ELEMS``).
- ``pack_gather_rows_reference`` writes the record that
  ``csrc/check_gather.cu`` documents, checked byte for byte against one
  built field by field in numpy; ``record_layout`` keeps records in whole
  sectors for every R.
- ``_launch_shape`` stays within CUDA's grid limits, covers every pod
  once for P up to 2^31 - 1, and the pack every throttle row.
- ``pack_args`` and ``launch_args`` pass their operands in the order of
  ``kt_pack_gather_rows``' and ``kt_check_gather``'s C signatures in
  ``csrc/check_gather.cu``.
- The CPU branch launches neither kernel; a tensor on any other device
  than the CPU or CUDA raises.
- The operands that ``pre_filter_batch``, the sparse tick and
  ``check_pods_multi`` hand the wrapper are what the kernel reads
  (dtype, shape, contiguity), so on the card the wrapper launches.

The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import re
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_throttler_tpu.ops import check as jcheck
from kube_throttler_tpu.ops import schema as jschema
from kube_throttler_tpu_torch.ops import check as tcheck
from kube_throttler_tpu_torch.ops import check_gather as cg
from kube_throttler_tpu_torch.ops.schema import (
    PodBatch,
    ThrottleState,
    pod_batch_from_arrays,
    throttle_state_from_arrays,
)

from torch_gather_cases import WIDE, gather_arrays as _arrays, gather_cell

CPU = "cpu"
VARIANTS = [(False, True), (True, True), (False, False), (True, False)]
INT32_MAX = 2**31 - 1


def _both(state, pods):
    """(JAX, port) ThrottleState and PodBatch of the same arrays."""
    js = jschema.ThrottleState(**{k: jnp.asarray(v) for k, v in state.items()})
    jp = jschema.PodBatch(**{k: jnp.asarray(v) for k, v in pods.items()})
    return (js, jp), (throttle_state_from_arrays(state, device=CPU),
                      pod_batch_from_arrays(pods, device=CPU))


def _assert_same(got, want, what):
    want = np.asarray(want)
    assert got.dtype == {np.int8: torch.int8, np.int32: torch.int32,
                         np.bool_: torch.bool}[want.dtype.type], what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=str(what))


def _assert_matches_jax(state, pods, cols, variants=VARIANTS):
    """Both forms of the port's gather check, and of the plain version
    over packed records, ≡ the JAX functions; returns the last variant's
    statuses."""
    (js, jp), (ts, tp) = _both(state, pods)
    tcols = torch.from_numpy(cols)
    R = ts.thr_req.shape[1]
    packed = cg.pack_gather_rows_reference(ts)
    for on_equal, step3 in variants:
        what = (cols.shape, on_equal, step3)
        want = jcheck.check_pods_gather_statuses(js, jp, jnp.asarray(cols),
                                                 on_equal=on_equal, step3_on_equal=step3)
        got = tcheck.check_pods_gather_statuses(ts, tp, tcols, on_equal=on_equal,
                                                step3_on_equal=step3)
        _assert_same(got, want, what)
        wc, ws = jcheck.check_pods_gather(js, jp, jnp.asarray(cols), on_equal=on_equal,
                                          step3_on_equal=step3)
        gc, gs = tcheck.check_pods_gather(ts, tp, tcols, on_equal=on_equal,
                                          step3_on_equal=step3)
        _assert_same(gc, wc, what)
        _assert_same(gs, ws, what)
        pk = cg.check_packed_reference(packed, tp, tcols, R, on_equal, step3, statuses=True)
        _assert_same(pk, want, ("packed",) + what)
        pc, ps = cg.check_packed_reference(packed, tp, tcols, R, on_equal, step3)
        _assert_same(pc, wc, ("packed",) + what)
        _assert_same(ps, ws, ("packed",) + what)
    return got


@pytest.mark.parametrize("K", [4, 32, 64, 2048])
@pytest.mark.parametrize("R", [3, 8, 16, 20])
def test_plain_matches_jax(K, R):
    """Every variant, both forms; all four statuses and NOT_AFFECTED occur."""
    (P, K, T, R), seed = gather_cell(K, R)
    state, pods, cols = _arrays(np.random.default_rng(seed), P, K, T, R)
    got = _assert_matches_jax(state, pods, cols)
    if K >= 32:
        assert set(np.unique(got.numpy()).tolist()) == {-1, 0, 1, 2, 3}


@pytest.mark.parametrize("K,R", WIDE)
def test_plain_matches_jax_past_32_dims(K, R):
    """R > 32: a record's per-dim masks take two words, and the pods
    request dims on both sides of 32."""
    (P, K, T, R), seed = gather_cell(K, R)
    state, pods, cols = _arrays(np.random.default_rng(seed), P, K, T, R)
    nz = pods["req_present"] & (pods["req"] != 0)
    assert nz[:, :32].any() and nz[:, 32:].any()
    got = _assert_matches_jax(state, pods, cols)
    assert set(np.unique(got.numpy()).tolist()) == {-1, 0, 1, 2, 3}


def _record_bytes(state, t):
    """Row t's record as ``csrc/check_gather.cu`` documents it, built field
    by field with ``struct``."""
    R = state["thr_req"].shape[1]
    W = max(1, -(-R // 32))
    header = 32 * -(-(16 + 16 * W) // 32)
    size = header + 32 * -(-R // 2)
    rec = bytearray(size)
    with np.errstate(over="ignore"):
        au_cnt = state["used_cnt"][t] + state["res_cnt"][t]
        au_req = state["used_req"][t] + state["res_req"][t]
    struct.pack_into("<qq", rec, 0, int(state["thr_cnt"][t]), int(au_cnt))
    lead = (int(state["valid"][t]) | int(state["thr_cnt_present"][t]) << 1
            | int(state["used_cnt_present"][t] | state["res_cnt_present"][t]) << 2
            | int(state["st_cnt_throttled"][t]) << 3)
    struct.pack_into("<I", rec, 16, lead)
    au_p = state["used_req_present"][t] | state["res_req_present"][t]
    st = state["st_req_flag_present"][t] & state["st_req_throttled"][t]
    for r in range(R):
        w, j = divmod(r, 32)
        for field, flags in ((1, state["thr_req_present"][t]), (2, au_p), (3, st)):
            at = 16 + 16 * w + 4 * field
            word = struct.unpack_from("<I", rec, at)[0] | int(flags[r]) << j
            struct.pack_into("<I", rec, at, word)
        struct.pack_into("<qq", rec, header + 16 * r, int(state["thr_req"][t, r]), int(au_req[r]))
    return bytes(rec)


@pytest.mark.parametrize("R,extremes", [(1, False), (3, True), (8, False), (20, True),
                                        (32, False), (33, True), (40, False), (65, False)])
def test_pack_writes_the_documented_record(R, extremes):
    """``pack_gather_rows_reference`` ≡ the record of the ``.cu`` header,
    byte for byte, row by row; every mask bit past R and every pad byte
    is 0."""
    rng = np.random.default_rng(R)
    state, _, _ = _arrays(rng, 2, 4, 24, R, extremes=extremes)
    ts = throttle_state_from_arrays(state, device=CPU)
    packed = cg.pack_gather_rows_reference(ts)
    layout = cg.record_layout(R)
    assert packed.dtype == torch.int64 and tuple(packed.shape) == (24, layout.words)
    raw = packed.numpy().view(np.uint8)
    for t in range(24):
        assert raw[t].tobytes() == _record_bytes(state, t), (R, t)
    assert cg.pack_gather_rows(ts).equal(packed)


@pytest.mark.parametrize("R", [0, 1, 8, 31, 32, 33, 64, 65, 96, 97, 200])
def test_record_layout_is_whole_sectors(R):
    """Header and record are whole 32-byte sectors; the header holds the
    count side and every mask group; a dim slot never straddles a sector.
    At R <= 32 the header is one sector, so a slot requesting one dim reads
    two."""
    W, header, words = cg.record_layout(R)
    assert W == max(1, -(-R // 32))
    assert header % 4 == 0 and words % 4 == 0
    assert 8 * header >= 16 + 16 * W and 8 * header < 16 + 16 * W + 32
    assert header + 2 * R <= words < header + 2 * R + 4
    if R <= 32:
        assert header == 4
    assert cg.record_layout(8) == (1, 4, 20)  # the tick's 160-byte record


def test_packed_reference_rejects_another_layout():
    rng = np.random.default_rng(5)
    state, pods, cols = _arrays(rng, 6, 4, 9, 3)
    ts, tp = _both(state, pods)[1]
    packed = cg.pack_gather_rows_reference(ts)
    with pytest.raises(ValueError, match="packed"):
        cg.check_packed_reference(packed, tp, torch.from_numpy(cols), 8)
    with pytest.raises(ValueError, match="packed"):
        cg.check_packed_reference(packed.int(), tp, torch.from_numpy(cols), 3)


def test_pads_invalid_rows_and_invalid_pods_are_not_affected():
    rng = np.random.default_rng(7)
    state, pods, cols = _arrays(rng, 40, 8, 30, 4)
    state["valid"][:] = True
    state["valid"][[2, 5]] = False
    pods["valid"][:] = True
    pods["valid"][3] = False
    cols[:] = rng.integers(0, 30, cols.shape)
    cols[0] = -1
    cols[1, :4] = 2
    cols[1, 4:] = 5
    cols[4, ::2] = -1
    got = _assert_matches_jax(state, pods, cols).numpy()
    assert (got[0] == -1).all() and (got[1] == -1).all() and (got[3] == -1).all()
    assert (got[4, ::2] == -1).all()
    counts, schedulable = tcheck.check_pods_gather(
        *_both(state, pods)[1], torch.from_numpy(cols))
    assert counts[[0, 1, 3]].sum() == 0 and schedulable[[0, 1, 3]].all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int64_extremes_wrap_as_in_jax(seed):
    """used + res and used + res + pod wrap as two's complement in both."""
    rng = np.random.default_rng(seed)
    state, pods, cols = _arrays(rng, 64, 16, 40, 3, extremes=True)
    with np.errstate(over="ignore"):
        au = state["used_req"] + state["res_req"]
        wrapped = (au < state["used_req"]) != (state["res_req"] < 0)
    assert wrapped.any()
    _assert_matches_jax(state, pods, cols)


@pytest.mark.parametrize("past", [0, 3])
def test_cols_at_or_past_t_clamp_to_the_last_row(past):
    """Fault (h): a col of T (or T + 3) reads row T - 1, as a JAX gather
    clamps it; the port raised IndexError before."""
    rng = np.random.default_rng(11 + past)
    T = 8
    state, pods, cols = _arrays(rng, 32, 6, T, 4)
    state["valid"][T - 1] = True
    pods["valid"][:] = True
    cols[:, 0] = T + past
    cols[::2, 1] = T + 3
    got = _assert_matches_jax(state, pods, cols)
    assert (got[:, 0] != -1).all()


@pytest.mark.parametrize("K", [4, 64])
def test_chunked_plain_matches_jax(K, monkeypatch):
    """A P-chunked plain version (blocks of a few pods) ≡ JAX."""
    rng = np.random.default_rng(K)
    state, pods, cols = _arrays(rng, 90, K, 200, 8)
    monkeypatch.setattr(cg, "_GATHER_CHUNK_ELEMS", 7 * K * 8)
    blocks = []
    body = cg._gather_statuses
    monkeypatch.setattr(cg, "_gather_statuses", lambda *a: blocks.append(1) or body(*a))
    _assert_matches_jax(state, pods, cols, variants=VARIANTS[:2])
    assert len(blocks) == 4 * 13  # 2 variants x 2 forms, each in 13 blocks of 7 pods


@pytest.mark.parametrize("P", [1, 7, 8, 9, 131072, 100_003, 2**31 - 1])
def test_launch_shape_within_cuda_limits(P):
    for T in (16384, 1, 9, P):
        threads, blocks, pack_threads, pack_blocks = cg._launch_shape(P, T)
        assert threads % 32 == 0 and threads <= 1024
        assert 1 <= blocks <= INT32_MAX
        pods_per_block = threads // 32 * cg._PODS_PER_WARP
        assert blocks * pods_per_block >= P > (blocks - 1) * pods_per_block
        # the pack: one warp a row, striding past 65,535 blocks
        assert pack_threads % 32 == 0 and pack_threads <= 1024
        rows_per_block = pack_threads // 32
        assert 1 <= pack_blocks <= 65535
        assert (pack_blocks * rows_per_block >= T > (pack_blocks - 1) * rows_per_block
                or pack_blocks == 65535)


def _c_params(name="kt_check_gather"):
    """Parameter names of C entry ``name`` in csrc/check_gather.cu."""
    src = (Path(cg.__file__).resolve().parent.parent / "csrc" / "check_gather.cu").read_text()
    sig = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S).group(1)
    return [re.split(r"[\s*]+", p.strip())[-1] for p in sig.split(",")]


@pytest.mark.parametrize("statuses", [False, True])
def test_launch_args_follow_the_c_signature(statuses):
    rng = np.random.default_rng(0)
    state, pods, cols = _arrays(rng, 5, 4, 7, 3)
    ts, tp = _both(state, pods)[1]
    tcols = torch.from_numpy(cols)
    out = torch.empty((5, 4), dtype=torch.int8) if statuses else None
    counts = None if statuses else torch.empty((5, 4), dtype=torch.int32)
    sched = None if statuses else torch.empty(5, dtype=torch.bool)

    shape = cg._launch_shape(5, 7)
    layout = cg.record_layout(3)
    packed = cg.pack_gather_rows_reference(ts)
    args = cg.launch_args(packed, tp, tcols, out, counts, sched, True, False, shape, 12345)
    params = _c_params()
    assert len(args) == len(params) == len(cg.ARGTYPES) == 20
    tensors = {f.name: getattr(ts, f.name) for f in dataclasses.fields(ThrottleState)}
    tensors.update(packed=packed, pod_valid=tp.valid, pod_req=tp.req, pod_present=tp.req_present,
                   cols=tcols, statuses=out, counts=counts, schedulable=sched)
    for name, arg in zip(params[:8], args[:8]):
        t = tensors[name]
        assert arg == (0 if t is None else t.data_ptr()), name
    assert dict(zip(params[8:], args[8:])) == {
        "P": 5, "K": 4, "T": 7, "R": 3, "header_words": layout.header_words,
        "words": layout.words, "on_equal": 1, "step3_on_equal": 0,
        "write_statuses": int(statuses), "threads": shape.threads, "blocks": shape.blocks,
        "stream": 12345,
    }
    # the pack: the 16 state planes in field order, then the buffer
    args = cg.pack_args(ts, packed, shape, 12345)
    params = _c_params("kt_pack_gather_rows")
    assert len(args) == len(params) == len(cg.PACK_ARGTYPES) == 24
    for name, arg in zip(params[:17], args[:17]):
        assert arg == tensors[name].data_ptr(), name
    assert dict(zip(params[17:], args[17:])) == {
        "T": 7, "R": 3, "header_words": layout.header_words, "words": layout.words,
        "threads": shape.pack_threads, "blocks": shape.pack_blocks, "stream": 12345,
    }


def test_cpu_branch_launches_nothing_and_other_devices_raise():
    rng = np.random.default_rng(2)
    state, pods, cols = _arrays(rng, 16, 4, 12, 3)
    ts, tp = _both(state, pods)[1]
    before, packs = cg.launches, cg.pack_launches
    counts, schedulable = cg.check_gather(ts, tp, torch.from_numpy(cols))
    statuses = cg.check_gather(ts, tp, torch.from_numpy(cols), statuses=True)
    assert cg.pack_gather_rows(ts).equal(cg.pack_gather_rows_reference(ts))
    assert cg.launches == before and cg.pack_launches == packs
    want = cg.check_gather_reference(ts, tp, torch.from_numpy(cols), statuses=True)
    assert torch.equal(statuses, want)
    assert torch.equal(counts, cg.check_gather_reference(ts, tp, torch.from_numpy(cols))[0])
    meta = lambda t: t.to("meta")  # noqa: E731
    mstate = ThrottleState(**{f.name: meta(getattr(ts, f.name))
                              for f in dataclasses.fields(ThrottleState)})
    mpods = PodBatch(valid=meta(tp.valid), req=meta(tp.req), req_present=meta(tp.req_present))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cg.check_gather(mstate, mpods, meta(torch.from_numpy(cols)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cg.pack_gather_rows(mstate)
    with pytest.raises(ValueError, match="resource-dim mismatch"):
        cg.check_gather(ts, PodBatch(valid=tp.valid, req=tp.req[:, :2],
                                     req_present=tp.req_present[:, :2]),
                        torch.from_numpy(cols))
    with pytest.raises(ValueError, match="cols shape"):
        cg.check_gather(ts, tp, torch.from_numpy(cols[:3]))
    assert cg.launches == before and cg.pack_launches == packs


def test_validate_rejects_what_the_kernel_does_not_read():
    rng = np.random.default_rng(3)
    state, pods, cols = _arrays(rng, 6, 4, 9, 3)
    ts, tp = _both(state, pods)[1]
    tcols = torch.from_numpy(cols)
    cg._validate(ts, tp, tcols)
    with pytest.raises(TypeError, match="cols"):
        cg._validate(ts, tp, tcols.long())
    with pytest.raises(ValueError, match="contiguous"):
        cg._validate(dataclasses.replace(ts, thr_req=ts.thr_req.t().contiguous().t()),
                     tp, tcols)
    with pytest.raises(TypeError, match="state.used_cnt"):
        cg._validate(dataclasses.replace(ts, used_cnt=ts.used_cnt.int()), tp, tcols)


def test_main_path_operands_are_what_the_kernel_reads(monkeypatch):
    """Every call that pre_filter_batch, the sparse tick and the coalescer's
    device route make passes the CUDA branch's operand checks."""
    import kube_throttler_tpu_torch.api.serialization as tser
    import kube_throttler_tpu_torch.engine.store as tstore
    import kube_throttler_tpu_torch.plugin as tplugin
    import kube_throttler_tpu_torch.utils.clock as tclock

    from tests.test_torch_prefilter_batch import build_stack

    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    calls = []
    real = cg.check_gather_reference

    def checked(state, pods, cols, *args):
        cg._validate(state, pods, cols)
        calls.append(args[-1])
        return real(state, pods, cols, *args)

    monkeypatch.setattr(cg, "check_gather_reference", checked)
    port = build_stack(tser, tstore, tplugin, tclock, device="cpu")
    port.pre_filter_batch()
    port.full_tick_sharded(1)
    dm = port.device_manager
    dm._single_check_device = True
    for kind in ("throttle", "clusterthrottle"):
        dm.check_pods_multi(port.listers.pods.list()[:20], kind)
    port.stop()
    # batch, tick: counts; the coalescer, one per kind: statuses
    assert calls.count(False) >= 2 and calls.count(True) == 2
