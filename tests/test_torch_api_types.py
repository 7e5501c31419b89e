"""Oracle decision-logic tests, golden-cased from the reference unit suites
(resource_amount_test.go, throttle_types_test.go,
temporary_threshold_override_test.go, *selector_test.go)."""

from datetime import datetime, timedelta, timezone

import pytest

from kube_throttler_tpu_torch.api import (
    CheckThrottleStatus,
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    IsResourceAmountThrottled,
    LabelSelector,
    Namespace,
    ResourceAmount,
    TemporaryThresholdOverride,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
    resource_amount_of_pod,
)
from kube_throttler_tpu_torch.api.types import (
    CalculatedThreshold,
    LabelSelectorRequirement,
    ThrottleSpecBase,
    ThrottleStatus,
)
from kube_throttler_tpu_torch.api.pod import make_pod

NOW = datetime(2024, 1, 15, 12, 0, 0, tzinfo=timezone.utc)


def rfc(dt: datetime) -> str:
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


class TestIsThrottled:
    def test_empty_threshold_never_throttles(self):
        # resource_amount_test.go:31-58
        empty = ResourceAmount()
        for on_equal in (False, True):
            got = empty.is_throttled(ResourceAmount.of(pod=3), on_equal)
            assert got == IsResourceAmountThrottled()
            got = empty.is_throttled(ResourceAmount.of(requests={"r1": "1000"}), on_equal)
            assert got == IsResourceAmountThrottled()

    def test_count_equality_boundary(self):
        # resource_amount_test.go:74-117: 3 vs 3 throttles only onEqual
        thr = ResourceAmount.of(pod=3, requests={"r1": "10", "r2": "20"})
        flags_false = {"r1": False, "r2": False}
        for on_equal in (False, True):
            got = thr.is_throttled(ResourceAmount.of(pod=2), on_equal)
            assert got == IsResourceAmountThrottled(False, flags_false)
        assert thr.is_throttled(ResourceAmount.of(pod=3), False) == IsResourceAmountThrottled(False, flags_false)
        assert thr.is_throttled(ResourceAmount.of(pod=3), True) == IsResourceAmountThrottled(True, flags_false)
        for on_equal in (False, True):
            assert thr.is_throttled(ResourceAmount.of(pod=4), on_equal) == IsResourceAmountThrottled(True, flags_false)

    def test_request_dims_evaluated_independently(self):
        thr = ResourceAmount.of(pod=3, requests={"r1": "10", "r2": "20"})
        got = thr.is_throttled(ResourceAmount.of(requests={"r1": "10", "r2": "19"}), True)
        assert got.resource_requests == {"r1": True, "r2": False}
        got = thr.is_throttled(ResourceAmount.of(requests={"r1": "10", "r2": "19"}), False)
        assert got.resource_requests == {"r1": False, "r2": False}
        got = thr.is_throttled(ResourceAmount.of(requests={"r1": "11", "r2": "21"}), False)
        assert got.resource_requests == {"r1": True, "r2": True}

    def test_used_dim_absent_from_threshold_unchecked(self):
        thr = ResourceAmount.of(requests={"r1": "10"})
        got = thr.is_throttled(ResourceAmount.of(requests={"r9": "99999"}), True)
        assert got.resource_requests == {"r1": False}

    def test_threshold_dim_absent_from_used_not_throttled(self):
        thr = ResourceAmount.of(requests={"r1": "10", "r2": "5"})
        got = thr.is_throttled(ResourceAmount.of(requests={"r1": "10"}), True)
        assert got.resource_requests == {"r1": True, "r2": False}


class TestIsThrottledFor:
    def test_pod_count_flag_always_blocks(self):
        flags = IsResourceAmountThrottled(resource_counts_pod=True)
        pod = make_pod("p")  # no requests at all
        assert flags.is_throttled_for(pod)

    def test_request_flag_blocks_only_nonzero_requesters(self):
        flags = IsResourceAmountThrottled(False, {"cpu": True})
        assert flags.is_throttled_for(make_pod("p", requests={"cpu": "100m"}))
        assert not flags.is_throttled_for(make_pod("p", requests={"memory": "1Gi"}))
        assert not flags.is_throttled_for(make_pod("p", requests={"cpu": "0"}))
        assert not flags.is_throttled_for(make_pod("p"))


class TestAddSub:
    def test_add_nil_counts(self):
        a = ResourceAmount().add(ResourceAmount.of(pod=2, requests={"cpu": "1"}))
        assert a.resource_counts == 2
        b = ResourceAmount.of(pod=1).add(ResourceAmount.of(requests={"cpu": "1"}))
        assert b.resource_counts == 1

    def test_sub_clamps_pod_count_but_not_requests(self):
        a = ResourceAmount.of(pod=1, requests={"cpu": "1"})
        got = a.sub(ResourceAmount.of(pod=5, requests={"cpu": "3"}))
        assert got.resource_counts == 0
        assert got.resource_requests["cpu"] < 0


class TestOverrides:
    def test_is_active_inclusive_boundaries(self):
        # temporary_threshold_override_test.go:40-101
        o = TemporaryThresholdOverride(begin=rfc(NOW), end=rfc(NOW + timedelta(hours=1)))
        assert o.is_active(NOW)
        assert o.is_active(NOW + timedelta(hours=1))
        assert not o.is_active(NOW - timedelta(seconds=1))
        assert not o.is_active(NOW + timedelta(hours=1, seconds=1))

    def test_open_ended(self):
        assert TemporaryThresholdOverride().is_active(NOW)
        assert TemporaryThresholdOverride(begin=rfc(NOW - timedelta(days=1))).is_active(NOW)
        assert TemporaryThresholdOverride(end=rfc(NOW + timedelta(days=1))).is_active(NOW)

    def test_bad_rfc3339_raises(self):
        with pytest.raises(ValueError):
            TemporaryThresholdOverride(begin="error").is_active(NOW)
        # date-only / missing offset are invalid under Go's RFC3339 layout
        with pytest.raises(ValueError):
            TemporaryThresholdOverride(begin="2024-01-15").is_active(NOW)
        with pytest.raises(ValueError):
            TemporaryThresholdOverride(begin="2024-01-15T12:00:00").is_active(NOW)


class TestCalculateThreshold:
    threshold = ResourceAmount.of(pod=5, requests={"cpu": "5", "memory": "5"})
    override1 = TemporaryThresholdOverride(
        begin=rfc(NOW - timedelta(hours=1)),
        end=rfc(NOW + timedelta(hours=1)),
        threshold=ResourceAmount.of(pod=2, requests={"cpu": "2"}),
    )
    override2 = TemporaryThresholdOverride(
        begin=rfc(NOW - timedelta(hours=2)),
        end=rfc(NOW + timedelta(hours=2)),
        threshold=ResourceAmount.of(pod=3, requests={"cpu": "3", "memory": "3"}),
    )

    def test_no_active_overrides(self):
        spec = ThrottleSpecBase(threshold=self.threshold)
        got = spec.calculate_threshold(NOW)
        assert got.threshold == self.threshold
        assert got.calculated_at == NOW
        assert got.messages == ()

    def test_single_active_override_replaces_whole_threshold(self):
        spec = ThrottleSpecBase(
            threshold=self.threshold, temporary_threshold_overrides=(self.override1,)
        )
        got = spec.calculate_threshold(NOW)
        # memory dim from spec does NOT leak through (throttle_types.go:96-98)
        assert got.threshold == self.override1.threshold

    def test_merge_first_wins_per_dimension(self):
        # throttle_types_test.go:110-133
        spec = ThrottleSpecBase(
            threshold=self.threshold,
            temporary_threshold_overrides=(self.override1, self.override2),
        )
        got = spec.calculate_threshold(NOW)
        assert got.threshold == ResourceAmount.of(pod=2, requests={"cpu": "2", "memory": "3"})

    def test_parse_error_skipped_with_message(self):
        # throttle_types_test.go:135-151
        errored = TemporaryThresholdOverride(begin="error", threshold=ResourceAmount.of(pod=9))
        spec = ThrottleSpecBase(
            threshold=self.threshold,
            temporary_threshold_overrides=(self.override1, errored),
        )
        got = spec.calculate_threshold(NOW)
        assert got.threshold == self.override1.threshold
        assert len(got.messages) == 1
        assert got.messages[0].startswith("index 1: Failed to parse Begin")

    def test_inactive_overrides_keep_spec_threshold(self):
        old = TemporaryThresholdOverride(
            begin=rfc(NOW - timedelta(days=2)),
            end=rfc(NOW - timedelta(days=1)),
            threshold=ResourceAmount.of(pod=1),
        )
        spec = ThrottleSpecBase(threshold=self.threshold, temporary_threshold_overrides=(old,))
        assert spec.calculate_threshold(NOW).threshold == self.threshold


class TestNextOverrideHappensIn:
    def test_soonest_future_boundary(self):
        o1 = TemporaryThresholdOverride(
            begin=rfc(NOW + timedelta(hours=2)), end=rfc(NOW + timedelta(hours=3))
        )
        o2 = TemporaryThresholdOverride(
            begin=rfc(NOW - timedelta(hours=1)), end=rfc(NOW + timedelta(minutes=30))
        )
        spec = ThrottleSpecBase(temporary_threshold_overrides=(o1, o2))
        assert spec.next_override_happens_in(NOW) == timedelta(minutes=30)

    def test_no_future_boundaries(self):
        o = TemporaryThresholdOverride(
            begin=rfc(NOW - timedelta(hours=2)), end=rfc(NOW - timedelta(hours=1))
        )
        spec = ThrottleSpecBase(temporary_threshold_overrides=(o,))
        assert spec.next_override_happens_in(NOW) is None

    def test_parse_error_skips_override(self):
        bad = TemporaryThresholdOverride(begin="nope", end=rfc(NOW + timedelta(hours=1)))
        spec = ThrottleSpecBase(temporary_threshold_overrides=(bad,))
        assert spec.next_override_happens_in(NOW) is None


class TestSelectors:
    def test_empty_selector_matches_nothing(self):
        # throttle_selector_test.go: empty selector matches nothing
        sel = ThrottleSelector()
        assert not sel.matches_to_pod(make_pod("p", labels={"a": "b"}))

    def test_empty_term_matches_everything(self):
        sel = ThrottleSelector(selector_terms=(ThrottleSelectorTerm(),))
        assert sel.matches_to_pod(make_pod("p"))
        assert sel.matches_to_pod(make_pod("p", labels={"x": "y"}))

    def test_terms_are_ored(self):
        sel = ThrottleSelector(
            selector_terms=(
                ThrottleSelectorTerm(LabelSelector(match_labels={"team": "a"})),
                ThrottleSelectorTerm(LabelSelector(match_labels={"team": "b"})),
            )
        )
        assert sel.matches_to_pod(make_pod("p", labels={"team": "a"}))
        assert sel.matches_to_pod(make_pod("p", labels={"team": "b"}))
        assert not sel.matches_to_pod(make_pod("p", labels={"team": "c"}))

    def test_match_expressions(self):
        sel = LabelSelector(
            match_expressions=(
                LabelSelectorRequirement("env", "In", ("prod", "staging")),
                LabelSelectorRequirement("canary", "DoesNotExist"),
            )
        )
        assert sel.matches({"env": "prod"})
        assert not sel.matches({"env": "dev"})
        assert not sel.matches({"env": "prod", "canary": "1"})
        assert not sel.matches({})

    def test_cluster_term_requires_namespace_and_pod_match(self):
        term = ClusterThrottleSelectorTerm(
            pod_selector=LabelSelector(match_labels={"throttle": "t1"}),
            namespace_selector=LabelSelector(match_labels={"throttle": "true"}),
        )
        sel = ClusterThrottleSelector(selector_terms=(term,))
        ns_match = Namespace("ns1", labels={"throttle": "true"})
        ns_other = Namespace("ns2")
        pod = make_pod("p", labels={"throttle": "t1"})
        assert sel.matches_to_pod(pod, ns_match)
        assert not sel.matches_to_pod(pod, ns_other)
        assert not sel.matches_to_pod(make_pod("p"), ns_match)
        assert sel.matches_to_namespace(ns_match)
        assert not sel.matches_to_namespace(ns_other)


class TestCheckThrottledFor:
    """The ordered 4-state check incl. the Throttle/ClusterThrottle
    onEqual asymmetry (throttle_types.go:143 vs clusterthrottle_types.go:45)."""

    def _throttle(self, threshold, used=None, throttled=None, calculated=None):
        status = ThrottleStatus(
            calculated_threshold=calculated or CalculatedThreshold(),
            throttled=throttled or IsResourceAmountThrottled(),
            used=used or ResourceAmount(),
        )
        return Throttle(name="t1", spec=ThrottleSpec(threshold=threshold), status=status)

    def test_pod_requests_exceeds_threshold(self):
        thr = self._throttle(ResourceAmount.of(requests={"cpu": "100m"}))
        pod = make_pod("p", requests={"cpu": "200m"})
        got = thr.check_throttled_for(pod, ResourceAmount(), False)
        assert got == CheckThrottleStatus.POD_REQUESTS_EXCEEDS_THRESHOLD

    def test_active_via_status_flags(self):
        thr = self._throttle(
            ResourceAmount.of(requests={"cpu": "1"}),
            throttled=IsResourceAmountThrottled(False, {"cpu": True}),
        )
        pod = make_pod("p", requests={"cpu": "100m"})
        assert thr.check_throttled_for(pod, ResourceAmount(), False) == CheckThrottleStatus.ACTIVE

    def test_active_via_used_plus_reserved_saturation(self):
        # Throttle step 3 hardcodes onEqual=True: used == threshold → active
        thr = self._throttle(
            ResourceAmount.of(requests={"cpu": "1"}),
            used=ResourceAmount.of(pod=2, requests={"cpu": "1"}),
        )
        pod = make_pod("p", requests={"cpu": "100m"})
        assert thr.check_throttled_for(pod, ResourceAmount(), False) == CheckThrottleStatus.ACTIVE

    def test_clusterthrottle_step3_uses_caller_flag(self):
        # same state on a ClusterThrottle with onEqual=False → falls through
        # to step 4: used+pod > threshold → insufficient
        clthr = ClusterThrottle(
            name="c1",
            spec=ClusterThrottleSpec(threshold=ResourceAmount.of(requests={"cpu": "1"})),
            status=ThrottleStatus(used=ResourceAmount.of(pod=2, requests={"cpu": "1"})),
        )
        pod = make_pod("p", requests={"cpu": "100m"})
        assert clthr.check_throttled_for(pod, ResourceAmount(), False) == CheckThrottleStatus.INSUFFICIENT
        # and with onEqual=True it matches the Throttle behavior
        assert clthr.check_throttled_for(pod, ResourceAmount(), True) == CheckThrottleStatus.ACTIVE

    def test_insufficient(self):
        thr = self._throttle(
            ResourceAmount.of(requests={"cpu": "1"}),
            used=ResourceAmount.of(pod=1, requests={"cpu": "900m"}),
        )
        pod = make_pod("p", requests={"cpu": "200m"})
        assert thr.check_throttled_for(pod, ResourceAmount(), False) == CheckThrottleStatus.INSUFFICIENT

    def test_not_throttled(self):
        thr = self._throttle(
            ResourceAmount.of(requests={"cpu": "1"}),
            used=ResourceAmount.of(pod=1, requests={"cpu": "500m"}),
        )
        pod = make_pod("p", requests={"cpu": "200m"})
        assert thr.check_throttled_for(pod, ResourceAmount(), False) == CheckThrottleStatus.NOT_THROTTLED

    def test_reserved_counts_toward_saturation(self):
        thr = self._throttle(
            ResourceAmount.of(requests={"cpu": "1"}),
            used=ResourceAmount.of(pod=1, requests={"cpu": "500m"}),
        )
        pod = make_pod("p", requests={"cpu": "200m"})
        reserved = ResourceAmount.of(pod=1, requests={"cpu": "500m"})
        assert thr.check_throttled_for(pod, reserved, False) == CheckThrottleStatus.ACTIVE

    def test_calculated_threshold_takes_precedence(self):
        thr = self._throttle(
            ResourceAmount.of(requests={"cpu": "10"}),
            calculated=CalculatedThreshold(
                threshold=ResourceAmount.of(requests={"cpu": "100m"}), calculated_at=NOW
            ),
        )
        pod = make_pod("p", requests={"cpu": "200m"})
        assert (
            thr.check_throttled_for(pod, ResourceAmount(), False)
            == CheckThrottleStatus.POD_REQUESTS_EXCEEDS_THRESHOLD
        )

    def test_pod_count_threshold_zero_blocks_any_pod(self):
        # pod-count 0 threshold: pod alone (count 1 > 0) → exceeds
        thr = self._throttle(ResourceAmount.of(pod=0))
        pod = make_pod("p")
        assert (
            thr.check_throttled_for(pod, ResourceAmount(), False)
            == CheckThrottleStatus.POD_REQUESTS_EXCEEDS_THRESHOLD
        )

    def test_unrelated_resource_not_blocked(self):
        # throttle saturated on cpu, pod requests only memory → not throttled
        thr = self._throttle(
            ResourceAmount.of(requests={"cpu": "200m"}),
            used=ResourceAmount.of(pod=1, requests={"cpu": "200m"}),
        )
        pod = make_pod("p", requests={"memory": "512Mi"})
        assert thr.check_throttled_for(pod, ResourceAmount(), False) == CheckThrottleStatus.NOT_THROTTLED


class TestReviewRegressions:
    """Regressions from the round-1 code review findings."""

    def test_huge_utc_offset_is_parse_error_not_crash(self):
        # offsets ≥24h must surface as override parse messages, not crash
        bad = TemporaryThresholdOverride(begin="2026-01-01T00:00:00+25:00")
        spec = ThrottleSpecBase(temporary_threshold_overrides=(bad,))
        got = spec.calculate_threshold(NOW)
        assert len(got.messages) == 1 and "index 0" in got.messages[0]
        assert spec.next_override_happens_in(NOW) is None

    def test_fractional_seconds_exact(self):
        from kube_throttler_tpu_torch.api.types import parse_rfc3339

        assert parse_rfc3339("2026-01-01T00:00:00.000249Z").microsecond == 249
        assert parse_rfc3339("2026-01-01T00:00:00.5Z").microsecond == 500000

    def test_empty_resource_counts_object_is_zero_threshold(self):
        from kube_throttler_tpu_torch.api.serialization import resource_amount_from_dict

        # Go unmarshals resourceCounts:{} to Pod:0 — present, not absent
        ra = resource_amount_from_dict({"resourceCounts": {}})
        assert ra.resource_counts == 0
        assert resource_amount_from_dict({}).resource_counts is None

    def test_invalid_selector_errors_before_label_compare(self):
        from kube_throttler_tpu_torch.api.types import SelectorError

        sel = LabelSelector(
            match_labels={"app": "web"},
            match_expressions=(LabelSelectorRequirement("k", "BadOp"),),
        )
        with pytest.raises(SelectorError):
            sel.matches({"app": "api"})  # matchLabels alone would fail → still error
