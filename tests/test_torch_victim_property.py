"""Hypothesis property: the batched victim-selection kernel
(ops/victim_select.py) is equivalent to the SEQUENTIAL host oracle
(policy/victims.py ``sequential_victim_select``) on the verdict, the
selected victim SET, and the remaining-deficit vector — over generated
contribution matrices, deficit vectors, and victim caps, plus the
padding form the device wrapper dispatches (ladder-padded rows/dims must
be inert). Each problem also goes through the JAX package's kernel and
its sequential oracle, which the port's must equal.

Guarded by importorskip like tests/test_gang_property.py; the seeded
deterministic twin (tests/test_policy.py TestKernelOracleSeeded) keeps
the equivalence tested on environments without hypothesis.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import torch

from kube_throttler_tpu_torch.ops.victim_select import victim_select
from kube_throttler_tpu_torch.policy.victims import sequential_victim_select
# the problems and the ladder padding, shared with the chip smoke's [props]
from torch_props import pad_problem, problems

from kube_throttler_tpu.ops.victim_select import victim_select as j_victim_select
from kube_throttler_tpu.policy.victims import sequential_victim_select as j_sequential


@settings(max_examples=60, deadline=None)
@given(problems())
def test_kernel_equals_sequential_oracle(problem):
    contrib, deficit, cap = problem
    ok_s, sel_s, rem_s = sequential_victim_select(deficit, contrib, max_victims=cap)
    sel_k, ok_k, rem_k = victim_select(
        torch.as_tensor(contrib), torch.as_tensor(deficit), max_victims=cap
    )
    assert bool(np.asarray(ok_k)) == ok_s
    assert list(np.nonzero(np.asarray(sel_k))[0]) == sel_s
    assert np.asarray(rem_k).tolist() == rem_s.tolist()
    # the JAX package's oracle and kernel on the same problem
    ok_j, sel_j, rem_j = j_sequential(deficit, contrib, max_victims=cap)
    assert (ok_j, sel_j, rem_j.tolist()) == (ok_s, sel_s, rem_s.tolist())
    sel_x, ok_x, rem_x = j_victim_select(contrib, deficit, max_victims=cap)
    assert np.asarray(sel_x).tolist() == np.asarray(sel_k).tolist()
    assert bool(np.asarray(ok_x)) == bool(np.asarray(ok_k))
    assert np.asarray(rem_x).tolist() == np.asarray(rem_k).tolist()


@settings(max_examples=25, deadline=None)
@given(problems(), st.integers(min_value=0, max_value=8))
def test_padding_is_inert(problem, pad):
    """Zero-padded candidate rows and zero-deficit dims — the wrapper's
    ladder form — never change the verdict or the selected set."""
    contrib, deficit, cap = problem
    contrib_p, deficit_p = pad_problem(contrib, deficit, pad)
    sel_a, ok_a, _ = victim_select(
        torch.as_tensor(contrib), torch.as_tensor(deficit), max_victims=cap
    )
    sel_b, ok_b, _ = victim_select(
        torch.as_tensor(contrib_p), torch.as_tensor(deficit_p), max_victims=cap
    )
    assert bool(np.asarray(ok_a)) == bool(np.asarray(ok_b))
    assert list(np.nonzero(np.asarray(sel_a))[0]) == list(
        np.nonzero(np.asarray(sel_b))[0]
    )
