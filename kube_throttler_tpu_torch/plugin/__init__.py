"""Scheduler-plugin front-end (reference pkg/scheduler_plugin/).

``KubeThrottler`` implements the scheduling-framework extension points the
reference registers (PreFilter, Reserve/Unreserve, EnqueueExtensions —
plugin.go:54-56) against this framework's own minimal framework surface.
"""

from .framework import ClusterEvent, EventRecorder, RecordingEventRecorder, Status, StatusCode  # noqa: F401
from .args import KubeThrottlerPluginArgs, decode_plugin_args  # noqa: F401
from .plugin import KubeThrottler  # noqa: F401
