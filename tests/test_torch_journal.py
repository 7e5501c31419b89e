"""Checkpoint/resume for standalone mode (SURVEY §5): the Store journal
makes the crash-only stance real — the reference's state of record is the
apiserver; standalone's is this durable event log."""

from __future__ import annotations

from dataclasses import replace

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.journal import attach
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _throttle(name, labels, **threshold):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(**threshold),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels=labels)),
                )
            ),
        ),
    )


def _bound(pod):
    bound = replace(pod, spec=replace(pod.spec, node_name="node-1"))
    bound.status.phase = "Running"
    return bound


def _populate(store):
    store.create_namespace(Namespace("default"))
    store.create_throttle(_throttle("t1", {"grp": "a"}, pod=10, requests={"cpu": "1"}))
    store.create_pod(_bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "300m"})))
    store.create_pod(make_pod("p2", labels={"grp": "a"}, requests={"cpu": "100m"}))
    store.delete_pod("default", "p2")


class TestJournal:
    def test_crash_resume_round_trip(self, tmp_path):
        path = str(tmp_path / "store.journal")
        store = Store()
        journal = attach(store, path)
        _populate(store)
        # a status write (the thing an informer resync could NOT recover in
        # standalone mode) must survive too
        thr = store.get_throttle("default", "t1")
        store.update_throttle_status(
            thr.with_status(replace(thr.status, used=ResourceAmount.of(pod=1)))
        )
        # crash: no close(), fresh process
        recovered = Store()
        attach(recovered, path).close()
        assert {p.key for p in recovered.list_pods()} == {"default/p1"}
        t1 = recovered.get_throttle("default", "t1")
        assert t1.spec.threshold == ResourceAmount.of(pod=10, requests={"cpu": "1"})
        assert t1.status.used.resource_counts == 1
        assert recovered.get_namespace("default") is not None
        journal.close()

    def test_truncated_tail_is_dropped(self, tmp_path):
        path = str(tmp_path / "store.journal")
        store = Store()
        journal = attach(store, path)
        _populate(store)
        journal.close()
        with open(path, "a") as f:
            f.write('{"type": "ADDED", "kind": "Pod", "obj')  # crash mid-write
        recovered = Store()
        attach(recovered, path).close()
        assert {p.key for p in recovered.list_pods()} == {"default/p1"}

    def test_torn_final_line_is_normal_not_corruption(self, tmp_path):
        """A torn FINAL line is the legal crash artifact: truncated
        silently, counted in torn_tails, and the journal health stays OK —
        an operator page for every unclean shutdown would be noise."""
        path = str(tmp_path / "store.journal")
        store = Store()
        journal = attach(store, path)
        _populate(store)
        journal.close()
        with open(path, "a") as f:
            f.write('{"type": "ADDED", "kind": "Pod", "obj')  # crash mid-write
        recovered = Store()
        j = attach(recovered, path)
        assert j.torn_tails == 1
        assert j.replay_skipped == 0
        state, detail = j.health_state()
        assert state == "ok"
        assert detail["tornTails"] == 1
        j.close()

    def test_interior_corruption_counts_and_degrades(self, tmp_path):
        """A bad line WITH good lines after it cannot be a crash tail —
        it is real corruption: skipped, counted, health degraded."""
        path = str(tmp_path / "store.journal")
        store = Store()
        journal = attach(store, path)
        store.create_namespace(Namespace("default"))
        journal.close()
        with open(path, "a") as f:
            f.write("{corrupt interior line!!\n")
        # more valid history lands AFTER the corruption
        store2 = Store()
        j2 = attach(store2, path)
        assert j2.replay_skipped == 1 and j2.torn_tails == 0
        store2.create_throttle(_throttle("t1", {"grp": "a"}, pod=10))
        state, _ = j2.health_state()
        assert state == "degraded"
        j2.close()
        # and the post-corruption throttle still replays on the NEXT restart
        store3 = Store()
        j3 = attach(store3, path)
        assert len(store3.list_throttles()) == 1
        assert j3.replay_skipped == 1  # the interior line, re-counted per replay
        j3.close()

    def test_trailing_run_counts_all_but_final_line_as_corruption(self, tmp_path):
        """Only the LAST line of a trailing corrupt run can be the
        crash-mid-write artifact; bad lines ahead of it had writes land
        after them, so they are genuine corruption: counted (degraded)
        while the final line truncates silently."""
        path = str(tmp_path / "store.journal")
        store = Store()
        journal = attach(store, path)
        _populate(store)
        journal.close()
        with open(path, "a") as f:
            f.write("!!corrupt-but-complete-line\n")
            f.write('{"type": "ADDED", "kind": "Pod", "obj')  # torn final
        recovered = Store()
        j = attach(recovered, path)
        assert j.replay_skipped == 1  # the complete-but-corrupt line
        assert j.torn_tails == 1  # the torn final line
        state, _ = j.health_state()
        assert state == "degraded"
        assert {p.key for p in recovered.list_pods()} == {"default/p1"}
        j.close()

    def test_post_corruption_appends_survive_the_next_restart(self, tmp_path):
        """attach() must truncate the corrupt tail BEFORE appending: events
        written after a corrupt line would otherwise be stranded behind the
        gap and silently lost on every later replay."""
        path = str(tmp_path / "store.journal")
        store = Store()
        journal = attach(store, path)
        store.create_namespace(Namespace("default"))
        journal.close()
        with open(path, "a") as f:
            f.write('{"type": "ADDED", "kind": "Pod", "obj')  # crash mid-write

        # restart 1: recovers, then writes MORE history
        store2 = Store()
        j2 = attach(store2, path)
        store2.create_throttle(_throttle("t1", {"grp": "a"}, pod=10))
        j2.close()

        # restart 2: the post-corruption throttle MUST still be there
        store3 = Store()
        attach(store3, path).close()
        assert len(store3.list_throttles()) == 1
        assert store3.get_namespace("default") is not None

    def test_compaction_preserves_state_and_shrinks_log(self, tmp_path):
        path = str(tmp_path / "store.journal")
        store = Store()
        journal = attach(store, path, compact_after=50)
        store.create_namespace(Namespace("default"))
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=10))
        pod = _bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "100m"}))
        store.create_pod(pod)
        for i in range(200):  # churn well past compact_after
            store.update_pod(
                _bound(
                    make_pod("p1", labels={"grp": "a"}, requests={"cpu": f"{100 + i}m"})
                )
            )
        journal.close()
        n_lines = sum(1 for _ in open(path))
        assert n_lines < 100  # compacted: snapshot + post-compaction tail
        recovered = Store()
        attach(recovered, path).close()
        assert len(recovered.list_pods()) == 1
        assert len(recovered.list_throttles()) == 1

    def test_daemon_resumes_with_live_state(self, tmp_path):
        """Full loop: daemon writes statuses, 'crashes', a new daemon over
        the same journal serves correct admission immediately."""
        path = str(tmp_path / "store.journal")
        store = Store()
        journal = attach(store, path)
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            store,
            use_device=True,
            device="cpu",
        )
        store.create_namespace(Namespace("default"))
        store.create_throttle(
            _throttle("t1", {"grp": "a"}, requests={"cpu": "1"})
        )
        store.create_pod(
            _bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "800m"}))
        )
        plugin.run_pending_once()
        assert store.get_throttle("default", "t1").status.used.resource_counts == 1
        plugin.stop()  # crash (journal deliberately not closed)

        store2 = Store()
        attach(store2, path)
        plugin2 = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            store2,
            use_device=True,
            device="cpu",
        )
        # recovered status is immediately live — no reconcile needed for the
        # status-flag step, exactly like a restart against a real apiserver
        assert store2.get_throttle("default", "t1").status.used.resource_counts == 1
        verdict = plugin2.pre_filter(
            make_pod("p2", labels={"grp": "a"}, requests={"cpu": "300m"})
        )
        assert not verdict.is_success()
        assert "throttle[insufficient]=default/t1" in verdict.reasons
        plugin2.stop()
