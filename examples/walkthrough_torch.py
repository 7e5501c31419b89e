"""The reference README walkthrough (README.md:202-375) against the full
stack of the PyTorch/CUDA port: in-memory apiserver → watch events →
controllers → kernel-served PreFilter on the card.

Run: python examples/walkthrough_torch.py [--device {cuda,cpu}]

It prints decisions only, the same lines as ``examples/walkthrough.py``.
"""

import argparse
import sys
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_throttler_tpu_torch.api import (
    LabelSelector,
    Namespace,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.api.pod import make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, RecordingEventRecorder, decode_plugin_args
from kube_throttler_tpu_torch.utils.platform import add_device_argument


def main():
    parser = argparse.ArgumentParser()
    add_device_argument(parser, "the device data plane")
    args = parser.parse_args()
    store = Store()
    store.create_namespace(Namespace("default"))
    recorder = RecordingEventRecorder()
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store,
        event_recorder=recorder,
        device=args.device,
    )

    store.create_throttle(
        Throttle(
            name="t1",
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(pod=5, requests={"cpu": "200m", "memory": "1Gi"}),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                    )
                ),
            ),
        )
    )
    plugin.run_pending_once()

    def attempt(pod):
        store.create_pod(pod)
        plugin.run_pending_once()
        status = plugin.pre_filter(pod)
        if status.is_success():
            plugin.reserve(pod)
            bound = replace(pod, spec=replace(pod.spec, node_name="node-1"))
            bound.status.phase = "Running"
            store.update_pod(bound)
            plugin.run_pending_once()
            print(f"  {pod.name}: SCHEDULED")
        else:
            print(f"  {pod.name}: Pending — {status.message()}")

    print("create pod1 (cpu=200m):")
    attempt(make_pod("pod1", labels={"throttle": "t1"}, requests={"cpu": "200m"}))
    thr = store.get_throttle("default", "t1")
    print(f"  t1 status: used={thr.status.used.to_dict()} throttled={thr.status.throttled.to_dict()}")

    print("create pod2 (cpu=300m):")
    attempt(make_pod("pod2", labels={"throttle": "t1"}, requests={"cpu": "300m"}))

    print("create pod1m (memory=512Mi):")
    attempt(make_pod("pod1m", labels={"throttle": "t1"}, requests={"memory": "512Mi"}))

    print("edit t1 threshold to cpu=700m:")
    thr = store.get_throttle("default", "t1")
    store.update_throttle(
        replace(thr, spec=replace(thr.spec, threshold=ResourceAmount.of(pod=5, requests={"cpu": "700m", "memory": "1Gi"})))
    )
    plugin.run_pending_once()
    print("retry pod2:")
    attempt_pod2 = store.get_pod("default", "pod2")
    status = plugin.pre_filter(attempt_pod2)
    if status.is_success():
        plugin.reserve(attempt_pod2)
        bound = replace(attempt_pod2, spec=replace(attempt_pod2.spec, node_name="node-1"))
        bound.status.phase = "Running"
        store.update_pod(bound)
        plugin.run_pending_once()
        print("  pod2: SCHEDULED")

    print("create pod3 (cpu=300m, used=500m of 700m):")
    attempt(make_pod("pod3", labels={"throttle": "t1"}, requests={"cpu": "300m"}))
    for e in recorder.events:
        print(f"  event: {e.pod_key} {e.event_type}/{e.reason}")


if __name__ == "__main__":
    main()
