"""Hypothesis strategies and oracle comparisons of the port's property tests.

One module for the port's property copies (``test_torch_property_oracle.py``,
``test_torch_victim_property.py``) and the chip smoke's ``[props]`` phase,
which puts this directory on ``sys.path`` and imports it on the card. It
imports neither JAX nor pytest's conftest.

- ``quantities``, ``amounts``, ``pod_requests``: the reference property
  file's strategies (``amounts`` and ``pod_requests`` take the resource
  names to draw from; the default is its four);
- ``single_cell``: one (pod, throttle) cell, its ordered 4-state oracle and
  its encoding on a device;
- ``problems``: the victim property file's selection problems;
- ``clusters`` / ``encode_cluster``: whole states for the kernels, built
  from pools of ``amounts`` spread over a grid of shapes (P and T up to a
  few hundred, R up to 20), masks and gather cols (drawn from [-2, T + 2]),
  and optionally int64 extremes written into every int64 plane;
- ``wide_problems``: victim problems on each of the kernel's routes, and
  ``victim_route``, the route its launch shape takes for M dims;
- ``*_mismatches``: each kernel against its plain version (and the oracle)
  on one drawn input, as a list of what differed (empty when equal).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np
import torch
from hypothesis import assume, strategies as st

from kube_throttler_tpu_torch import quantity as qt
from kube_throttler_tpu_torch.api.pod import make_pod
from kube_throttler_tpu_torch.api.types import (
    ResourceAmount,
    Throttle,
    ThrottleSpec,
    ThrottleStatus,
    _check_throttled_for,
)
from kube_throttler_tpu_torch.ops.check import STATUS_NAMES
from kube_throttler_tpu_torch.ops.schema import DimRegistry, encode_pods, encode_throttle_state
from torch_gather_cases import EXTREMES

#: the four onEqual / step-3 onEqual variants
VARIANTS = ((False, False), (False, True), (True, False), (True, True))

# ---------------------------------------------------------------- strategies

SUFFIXES = ["", "m", "k", "M", "G", "Ki", "Mi", "Gi"]


@st.composite
def quantities(draw):
    n = draw(st.integers(min_value=0, max_value=10**12))
    if draw(st.integers(min_value=0, max_value=4)) == 0:
        # decimal forms — many are sub-milli (e.g. "100.5m", "0.0001"),
        # exercising the loud SubMilliPrecisionError rejection path
        frac = draw(st.integers(min_value=1, max_value=9999))
        return f"{n}.{frac}{draw(st.sampled_from(SUFFIXES))}"
    return f"{n}{draw(st.sampled_from(SUFFIXES))}"


RESOURCES = ["cpu", "memory", "nvidia.com/gpu", "storage"]
#: resource names past the reference's four, so a drawn state reaches R = 20
WIDE_RESOURCES = RESOURCES + [f"example.com/r{i}" for i in range(16)]


@st.composite
def amounts(draw, resources=tuple(RESOURCES)):
    cnt = draw(st.one_of(st.none(), st.integers(min_value=0, max_value=50)))
    reqs = draw(
        st.one_of(
            st.none(),
            st.dictionaries(st.sampled_from(resources), quantities(), max_size=3),
        )
    )
    return ResourceAmount.of(pod=cnt, requests=reqs)


@st.composite
def pod_requests(draw, resources=tuple(RESOURCES)):
    return draw(st.dictionaries(st.sampled_from(resources), quantities(), max_size=3))


def representable(v) -> bool:
    try:
        qt.to_milli(v)
        return True
    except qt.SubMilliPrecisionError:
        return False


# ------------------------------------------------------- one cell, oracle


def single_cell(threshold, used, reserved, pod_reqs, on_equal, step3_on_equal, device):
    """(oracle status name, state, batch, mask) of one (pod, throttle) cell
    on ``device``. Sub-milli-unrepresentable quantities are filtered up
    front (the encoder rejects them loudly; the oracle works in exact
    Fractions) with ``assume()``, so Hypothesis health-checks the filter
    rate instead of passing vacuously."""
    for amt in (threshold, used, reserved):
        assume(all(representable(v) for v in (amt.resource_requests or {}).values()))
    assume(all(representable(qt.parse_quantity(v)) for v in pod_reqs.values()))

    pod = make_pod("p", requests=pod_reqs)
    status = ThrottleStatus(used=used, throttled=threshold.is_throttled(used, True))
    thr = Throttle(
        name="t",
        spec=ThrottleSpec(throttler_name="x", threshold=threshold),
        status=status,
    )
    oracle = _check_throttled_for(threshold, status, pod, reserved, on_equal, step3_on_equal)

    dims = DimRegistry()
    for name in pod_reqs:
        dims.index_of(name)
    state = encode_throttle_state([thr], dims, reserved=[reserved], device=device)
    batch = encode_pods([pod], dims, device=device)
    mask = torch.ones((1, 1), dtype=torch.bool, device=device)
    return oracle, state, batch, mask


def single_cell_mismatches(threshold, used, reserved, pod_reqs, on_equal, step3_on_equal,
                           device) -> List[str]:
    """``check_dense`` over the cell's precompute ≡ its plain version ≡ the
    ordered 4-state oracle."""
    from kube_throttler_tpu_torch.ops import check_dense as cd
    from kube_throttler_tpu_torch.ops.fastcheck import precompute_check_state

    oracle, state, batch, mask = single_cell(threshold, used, reserved, pod_reqs, on_equal,
                                             step3_on_equal, device)
    pre = precompute_check_state(state)
    got = cd.check_dense(pre, batch, mask, on_equal, step3_on_equal)
    want = cd.check_dense_reference(pre, batch, mask, on_equal, step3_on_equal)
    bad = _differ("check_dense", got, want)
    if STATUS_NAMES[int(got[0, 0])] != oracle:
        bad.append(f"check_dense {STATUS_NAMES[int(got[0, 0])]} != oracle {oracle}")
    return bad


# --------------------------------------------------------- victim problems

victim_amounts = st.sampled_from([0, 0, 1, 2, 5, 100, 333, 1000])
deficits = st.sampled_from([0, 1, 4, 250, 900, 2000])


@st.composite
def problems(draw):
    n = draw(st.integers(min_value=1, max_value=32))
    m = draw(st.integers(min_value=1, max_value=6))
    contrib = np.array(
        [[draw(victim_amounts) for _ in range(m)] for _ in range(n)], dtype=np.int64
    )
    deficit = np.array([draw(deficits) for _ in range(m)], dtype=np.int64)
    cap = draw(st.sampled_from([0, 0, 1, 2, n]))
    return contrib, deficit, cap


def pad_problem(contrib, deficit, pad: int):
    """The wrapper's ladder form: ``pad`` zero candidate rows and ``pad``
    zero-deficit dims after the problem's own."""
    n, m = contrib.shape
    contrib_p = np.zeros((n + pad, m + pad), dtype=np.int64)
    contrib_p[:n, :m] = contrib
    deficit_p = np.zeros(m + pad, dtype=np.int64)
    deficit_p[:m] = deficit
    return contrib_p, deficit_p


#: the victim kernel's routes by M (``ops/victim_select.py::_launch_shape``):
#: one consumer warp up to 64 dims, eight past it, rows read from device
#: memory past 7,256 with remaining in registers up to 8,192 columns, its
#: rest in shared memory up to 37,216 and in device memory past that
VICTIM_ROUTES = {"warp": (1, 64), "ring": (65, 7256), "wide_regs": (7257, 8192),
                 "wide_smem": (8193, 37216), "wide_device": (37217, 40000)}
#: candidate rows per problem: fewer where a row is past 8,192 columns
_ROUTE_ROWS = {"warp": 48, "ring": 48, "wide_regs": 48, "wide_smem": 16, "wide_device": 8}
_WIDE_VALUES = np.array([0, 0, 0, 1, 2, 5, 100, 333, 1000, 10**9, 2**40], dtype=np.int64)


def victim_route(m: int) -> str:
    """The route of VICTIM_ROUTES that the kernel launches for ``m`` dims,
    by its own launch shape."""
    from kube_throttler_tpu_torch.ops.victim_select import _launch_shape

    shape = _launch_shape(m)
    if shape.route == "ring":
        return "warp" if shape.consumers == 1 else "ring"
    return {"registers": "wide_regs", "registers+shared": "wide_smem",
            "registers+device": "wide_device"}[shape.remaining_in]


@st.composite
def wide_problems(draw, route: str):
    """(contrib, deficit, cap, route) on one of the kernel's routes: rows
    drawn from a seeded numpy generator (up to ~650,000 cells), caps 0, 1
    and above."""
    lo, hi = VICTIM_ROUTES[route]
    m = draw(st.integers(min_value=lo, max_value=hi))
    n = draw(st.integers(min_value=1, max_value=_ROUTE_ROWS[route]))
    rng = np.random.default_rng(draw(st.integers(min_value=0, max_value=2**32 - 1)))
    density = draw(st.sampled_from([0.01, 0.2, 1.0]))
    contrib = np.where(rng.random((n, m)) < density, rng.choice(_WIDE_VALUES, (n, m)), 0)
    deficit = np.where(rng.random(m) < density, rng.choice(_WIDE_VALUES, m), 0)
    cap = draw(st.sampled_from([0, 1, 2, n, n + 3]))
    return contrib.astype(np.int64), deficit.astype(np.int64), cap, route


def victim_mismatches(contrib, deficit, cap: int, device) -> List[str]:
    """``victim_select`` ≡ the sequential host oracle (verdict, selected
    set, remaining deficits) ≡ its plain version, on ``device``."""
    from kube_throttler_tpu_torch.ops import victim_select as vsel
    from kube_throttler_tpu_torch.policy.victims import sequential_victim_select

    ok_s, sel_s, rem_s = sequential_victim_select(deficit, contrib, max_victims=cap)
    c = torch.as_tensor(contrib).to(device)
    d = torch.as_tensor(deficit).to(device)
    sel_k, ok_k, rem_k = vsel.victim_select(c, d, max_victims=cap)
    sel_r, ok_r, rem_r = vsel.victim_select_reference(c, d, max_victims=cap)
    bad = []
    if bool(ok_k) != ok_s:
        bad.append(f"ok {bool(ok_k)} != oracle {ok_s}")
    got = torch.nonzero(sel_k).flatten().tolist()
    if got != list(sel_s):
        bad.append(f"selected {got} != oracle {list(sel_s)}")
    if rem_k.tolist() != rem_s.tolist():
        bad.append("remaining deficits differ from the oracle")
    for name, g, w in (("selected", sel_k, sel_r), ("ok", ok_k, ok_r),
                       ("remaining", rem_k, rem_r)):
        bad += _differ(f"victim_select {name}", g, w)
    return bad


def victim_padding_mismatches(contrib, deficit, cap: int, pad: int, device) -> List[str]:
    """Zero-padded rows and zero-deficit dims never change the verdict or
    the selected set."""
    from kube_throttler_tpu_torch.ops import victim_select as vsel

    contrib_p, deficit_p = pad_problem(contrib, deficit, pad)
    sel_a, ok_a, _ = vsel.victim_select(torch.as_tensor(contrib).to(device),
                                        torch.as_tensor(deficit).to(device), max_victims=cap)
    sel_b, ok_b, _ = vsel.victim_select(torch.as_tensor(contrib_p).to(device),
                                        torch.as_tensor(deficit_p).to(device), max_victims=cap)
    bad = []
    if bool(ok_a) != bool(ok_b):
        bad.append(f"padding moved ok: {bool(ok_a)} -> {bool(ok_b)}")
    if torch.nonzero(sel_a).flatten().tolist() != torch.nonzero(sel_b).flatten().tolist():
        bad.append("padding moved the selected set")
    return bad


# ------------------------------------------------------------ whole states


@dataclass(frozen=True)
class Cluster:
    """A drawn state: its shape, the amounts its rows and pods are spread
    from, and the seed that spreads them."""

    P: int
    T: int
    R: int
    K: int
    throttles: Tuple[Tuple[ResourceAmount, ResourceAmount, ResourceAmount], ...]
    pods: Tuple[dict, ...]
    seed: int
    density: float
    extremes: bool


def _representable_amount(a: ResourceAmount) -> ResourceAmount:
    reqs = a.resource_requests
    if reqs is None:
        return a
    return replace(a, resource_requests={k: v for k, v in reqs.items() if representable(v)})


@st.composite
def clusters(draw, max_p: int = 300, max_t: int = 300, max_r: int = 20, max_k: int = 40):
    """A grid of shapes (P, T from 1 to a few hundred, R up to 20, K up to
    40) over pools of up to six (threshold, used, reserved) amounts and six
    pod requests drawn with :func:`amounts` and :func:`pod_requests`."""
    size = draw(st.sampled_from(["one", "small", "large"]))
    top_p, top_t = {"one": (1, 1), "small": (8, 8), "large": (max_p, max_t)}[size]
    P = draw(st.integers(min_value=1, max_value=top_p))
    T = draw(st.integers(min_value=1, max_value=top_t))
    R = draw(st.integers(min_value=1, max_value=max_r))
    names = tuple(WIDE_RESOURCES[:R])
    thr = draw(st.lists(st.tuples(amounts(names), amounts(names), amounts(names)),
                        min_size=1, max_size=6))
    pods = draw(st.lists(pod_requests(names), min_size=1, max_size=6))
    return Cluster(
        P=P, T=T, R=R, K=draw(st.integers(min_value=1, max_value=max_k)),
        throttles=tuple(tuple(_representable_amount(a) for a in t) for t in thr),
        pods=tuple({k: v for k, v in p.items() if representable(qt.parse_quantity(v))}
                   for p in pods),
        seed=draw(st.integers(min_value=0, max_value=2**32 - 1)),
        density=draw(st.sampled_from([0.0, 0.1, 0.5, 1.0])),
        extremes=draw(st.sampled_from([False, False, True])),
    )


_I64_STATE_PLANES = ("thr_cnt", "thr_req", "used_cnt", "used_req", "res_cnt", "res_req")


def encode_cluster(c: Cluster, device):
    """(state, batch, mask bool[P,T], cols int32[P,K]) of ``c`` on
    ``device``: throttle rows and pods spread from the pools by the seed,
    a few rows invalid, mask cells set with the drawn density, cols drawn
    from [-2, T + 2] (below 0 a pad, at or past T clamped to row T - 1);
    with ``extremes``, a quarter of every int64 plane's cells drawn from
    the int64 extremes, so used + res + pod wraps."""
    rng = np.random.default_rng(c.seed)
    dims = DimRegistry(capacity=c.R)
    for name in WIDE_RESOURCES[: c.R]:
        dims.index_of(name)
    rows, reserved = [], []
    for t in range(c.T):
        threshold, used, res = c.throttles[rng.integers(len(c.throttles))]
        status = ThrottleStatus(used=used, throttled=threshold.is_throttled(used, True))
        rows.append(Throttle(name=f"t{t}", spec=ThrottleSpec(throttler_name="x",
                                                            threshold=threshold),
                             status=status))
        reserved.append(res)
    pods = [make_pod(f"p{i}", requests=c.pods[rng.integers(len(c.pods))]) for i in range(c.P)]
    state = encode_throttle_state(rows, dims, reserved=reserved, device="cpu")
    batch = encode_pods(pods, dims, device="cpu")
    assert state.thr_req.shape[1] == batch.req.shape[1] == c.R
    ext = np.array(EXTREMES, dtype=np.int64)

    def extreme(t):
        a = t.numpy().copy()
        hit = rng.random(a.shape) < 0.25
        a[hit] = rng.choice(ext, int(hit.sum()))
        return torch.from_numpy(a)

    fields = {}
    for name in state.__dataclass_fields__:
        v = getattr(state, name)
        if name == "valid":
            v = v & torch.from_numpy(rng.random(c.T) < 0.9)
        elif c.extremes and name in _I64_STATE_PLANES:
            v = extreme(v)
        fields[name] = v.to(device)
    state = type(state)(**fields)
    req = extreme(batch.req) if c.extremes else batch.req
    valid = batch.valid & torch.from_numpy(rng.random(c.P) < 0.95)
    batch = type(batch)(valid=valid.to(device), req=req.to(device),
                        req_present=batch.req_present.to(device))
    mask = torch.from_numpy(rng.random((c.P, c.T)) < c.density).to(device)
    cols = torch.from_numpy(rng.integers(-2, c.T + 3, (c.P, c.K), dtype=np.int32)).to(device)
    return state, batch, mask, cols


def dense_mismatches(c: Cluster, device) -> List[str]:
    """``check_dense`` over ``precompute_check_state`` ≡ its plain version,
    all four variants."""
    from kube_throttler_tpu_torch.ops import check_dense as cd
    from kube_throttler_tpu_torch.ops.fastcheck import precompute_check_state

    state, batch, mask, _ = encode_cluster(c, device)
    pre = precompute_check_state(state)
    bad = []
    for on_equal, step3 in VARIANTS:
        got = cd.check_dense(pre, batch, mask, on_equal, step3)
        want = cd.check_dense_reference(pre, batch, mask, on_equal, step3)
        bad += _differ(f"check_dense on_equal={on_equal} step3={step3}", got, want)
    return bad


def gather_mismatches(c: Cluster, device) -> List[str]:
    """``check_gather`` (its pack included) ≡ its plain version, counts and
    statuses forms, all four variants; the pack's records ≡ the plain
    pack's, word for word."""
    from kube_throttler_tpu_torch.ops import check_gather as cg

    state, batch, _, cols = encode_cluster(c, device)
    bad = _differ("pack_gather_rows", cg.pack_gather_rows(state),
                  cg.pack_gather_rows_reference(state))
    for on_equal, step3 in VARIANTS:
        what = f"on_equal={on_equal} step3={step3}"
        got_s = cg.check_gather(state, batch, cols, on_equal, step3, statuses=True)
        want_s = cg.check_gather_reference(state, batch, cols, on_equal, step3, statuses=True)
        bad += _differ(f"check_gather statuses {what}", got_s, want_s)
        got_c, got_b = cg.check_gather(state, batch, cols, on_equal, step3)
        want_c, want_b = cg.check_gather_reference(state, batch, cols, on_equal, step3)
        bad += _differ(f"check_gather counts {what}", got_c, want_c)
        bad += _differ(f"check_gather schedulable {what}", got_b, want_b)
    return bad


def _differ(what: str, got: torch.Tensor, want: torch.Tensor) -> List[str]:
    if got.dtype != want.dtype or got.shape != want.shape:
        return [f"{what}: {got.dtype}{tuple(got.shape)} != {want.dtype}{tuple(want.shape)}"]
    n = int((got != want).sum())
    return [f"{what}: {n} of {got.numel()} differ"] if n else []
