"""ResourceList arithmetic vs reference resourcelist_test.go semantics."""

from fractions import Fraction

from kube_throttler_tpu_torch import resourcelist as rl
from kube_throttler_tpu_torch.api.pod import Container, make_pod
from kube_throttler_tpu_torch.quantity import parse_quantity as q


def RL(**kwargs):
    return {k: q(v) for k, v in kwargs.items()}


class TestPodRequestResourceList:
    def test_containers_sum(self):
        pod = make_pod("p", requests={"cpu": "100m"})
        pod.spec.containers.append(Container.of({"cpu": "200m", "memory": "1Gi"}))
        got = rl.pod_request_resource_list(pod)
        assert got == RL(cpu="300m", memory="1Gi")

    def test_init_containers_max_wins_over_sum(self):
        # effective = max(max(initContainers), sum(containers))
        pod = make_pod(
            "p",
            requests={"cpu": "100m"},
            init_requests=[{"cpu": "500m"}, {"cpu": "300m", "memory": "2Gi"}],
        )
        got = rl.pod_request_resource_list(pod)
        assert got == RL(cpu="500m", memory="2Gi")

    def test_overhead_added(self):
        pod = make_pod("p", requests={"cpu": "100m"}, overhead={"cpu": "10m"})
        assert rl.pod_request_resource_list(pod) == RL(cpu="110m")

    def test_no_requests(self):
        pod = make_pod("p")
        assert rl.pod_request_resource_list(pod) == {}


class TestArithmetic:
    def test_add_merges_missing_keys(self):
        a = RL(cpu="1")
        rl.add(a, RL(cpu="1", memory="1Gi"))
        assert a == RL(cpu="2", memory="1Gi")

    def test_sub_can_go_negative(self):
        a = RL(cpu="1")
        rl.sub(a, RL(cpu="2", memory="1Gi"))
        assert a == {"cpu": q("-1"), "memory": -q("1Gi")}

    def test_greater_or_equal(self):
        assert rl.greater_or_equal(RL(cpu="2", memory="1Gi"), RL(cpu="1"))
        assert rl.greater_or_equal(RL(cpu="1"), RL(cpu="1"))
        assert not rl.greater_or_equal(RL(cpu="1"), RL(cpu="2"))
        # key missing from lhs fails regardless of value
        assert not rl.greater_or_equal(RL(cpu="5"), RL(memory="0"))
        # empty rhs always satisfied
        assert rl.greater_or_equal({}, {})

    def test_set_max(self):
        a = RL(cpu="1", memory="2Gi")
        rl.set_max(a, RL(cpu="3", gpu="1"))
        assert a == RL(cpu="3", memory="2Gi", gpu="1")

    def test_set_min_drops_lhs_only_keys(self):
        a = RL(cpu="3", memory="2Gi")
        rl.set_min(a, RL(cpu="1", gpu="7"))
        assert a == RL(cpu="1")

    def test_equal_to_missing_reads_zero(self):
        assert rl.equal_to(RL(cpu="0"), {})
        assert rl.equal_to({}, RL(cpu="0"))
        assert not rl.equal_to(RL(cpu="1"), {})
        assert rl.equal_to(RL(cpu="100m"), RL(cpu="0.1"))
