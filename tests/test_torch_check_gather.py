"""The sparse gather check of the port (``ops/check_gather.py``) on the CPU.

- The plain version ≡ the JAX package's ``check_pods_gather`` and
  ``check_pods_gather_statuses``, bit for bit and dtype for dtype, on
  seeded raw arrays (``tests/torch_gather_cases.py``, which the card's
  tests and ``chip_smoke.py`` share): K in {4, 32, 64, 2048} × R in {3, 8, 16, 20}, all four
  (onEqual, step-3 onEqual) variants; -1 pads, invalid throttle rows and
  invalid pods; int64 extremes where ``used + res + pod`` wraps; cols equal
  to T and T + 3 (fault (h): JAX clamps them to row T - 1, where torch
  raised); a P-chunked plain version (``KT_GATHER_CHUNK_ELEMS``).
- ``_launch_shape`` stays within CUDA's grid limits and covers every pod
  once for P up to 2^31 - 1.
- ``launch_args`` passes its operands in the order of ``kt_check_gather``'s
  C signature in ``csrc/check_gather.cu``.
- The CPU branch launches nothing; a tensor on any other device than the
  CPU or CUDA raises.
- The operands that ``pre_filter_batch``, the sparse tick and
  ``check_pods_multi`` hand the wrapper are what the kernel reads
  (dtype, shape, contiguity), so on the card the wrapper launches.

The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import re
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

from torch_gather_cases import gather_arrays as _arrays, gather_cell

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
    """Both forms of the port's gather check ≡ the JAX functions; returns
    the last variant's statuses."""
    (js, jp), (ts, tp) = _both(state, pods)
    tcols = torch.from_numpy(cols)
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
    threads, blocks = cg._launch_shape(P)
    assert threads % 32 == 0 and threads <= 1024
    assert 1 <= blocks <= INT32_MAX
    pods_per_block = threads // 32
    assert blocks * pods_per_block >= P > (blocks - 1) * pods_per_block


def _c_params():
    """Parameter names of ``kt_check_gather`` in csrc/check_gather.cu."""
    src = (Path(cg.__file__).resolve().parent.parent / "csrc" / "check_gather.cu").read_text()
    sig = re.search(r'extern "C" int kt_check_gather\((.*?)\)\s*\{', src, re.S).group(1)
    return [re.split(r"[\s*]+", p.strip())[-1] for p in sig.split(",")]


@pytest.mark.parametrize("statuses", [False, True])
def test_launch_args_follow_the_c_signature(statuses, monkeypatch):
    rng = np.random.default_rng(0)
    state, pods, cols = _arrays(rng, 5, 4, 7, 3)
    ts, tp = _both(state, pods)[1]
    tcols = torch.from_numpy(cols)
    out = torch.empty((5, 4), dtype=torch.int8) if statuses else None
    counts = None if statuses else torch.empty((5, 4), dtype=torch.int32)
    sched = None if statuses else torch.empty(5, dtype=torch.bool)

    class _Stream:
        cuda_stream = 12345

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    shape = cg._launch_shape(5)
    args = cg.launch_args(ts, tp, tcols, out, counts, sched, True, False, shape)
    params = _c_params()
    assert len(args) == len(params) == len(cg.ARGTYPES) == 33
    tensors = {f.name: getattr(ts, f.name) for f in dataclasses.fields(ThrottleState)}
    tensors.update(pod_valid=tp.valid, pod_req=tp.req, pod_present=tp.req_present,
                   cols=tcols, statuses=out, counts=counts, schedulable=sched)
    for name, arg in zip(params[:23], args[:23]):
        t = tensors[name]
        assert arg == (0 if t is None else t.data_ptr()), name
    assert dict(zip(params[23:], args[23:])) == {
        "P": 5, "K": 4, "T": 7, "R": 3, "on_equal": 1, "step3_on_equal": 0,
        "write_statuses": int(statuses), "threads": shape[0], "blocks": shape[1],
        "stream": 12345,
    }


def test_cpu_branch_launches_nothing_and_other_devices_raise():
    rng = np.random.default_rng(2)
    state, pods, cols = _arrays(rng, 16, 4, 12, 3)
    ts, tp = _both(state, pods)[1]
    before = cg.launches
    counts, schedulable = cg.check_gather(ts, tp, torch.from_numpy(cols))
    statuses = cg.check_gather(ts, tp, torch.from_numpy(cols), statuses=True)
    assert cg.launches == before
    want = cg.check_gather_reference(ts, tp, torch.from_numpy(cols), statuses=True)
    assert torch.equal(statuses, want)
    assert torch.equal(counts, cg.check_gather_reference(ts, tp, torch.from_numpy(cols))[0])
    meta = lambda t: t.to("meta")  # noqa: E731
    mstate = ThrottleState(**{f.name: meta(getattr(ts, f.name))
                              for f in dataclasses.fields(ThrottleState)})
    mpods = PodBatch(valid=meta(tp.valid), req=meta(tp.req), req_present=meta(tp.req_present))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cg.check_gather(mstate, mpods, meta(torch.from_numpy(cols)))
    with pytest.raises(ValueError, match="resource-dim mismatch"):
        cg.check_gather(ts, PodBatch(valid=tp.valid, req=tp.req[:, :2],
                                     req_present=tp.req_present[:, :2]),
                        torch.from_numpy(cols))
    with pytest.raises(ValueError, match="cols shape"):
        cg.check_gather(ts, tp, torch.from_numpy(cols[:3]))
    assert cg.launches == before


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
