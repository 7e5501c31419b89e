"""``utils.tracing.device_trace``: a ``torch.profiler`` trace of the
enclosed block, written as a Chrome trace into ``log_dir``; a no-op with
one warning when the profiler cannot start or stop."""

import json
import logging

import torch

from kube_throttler_tpu_torch.utils import tracing


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "traces"
    with tracing.device_trace(str(log_dir)):
        x = torch.arange(4096, dtype=torch.int64)
        assert int((x * 3).sum()) == 3 * 4095 * 4096 // 2
    files = list(log_dir.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::") for n in names)


def test_device_trace_is_a_noop_when_the_profiler_cannot_start(tmp_path, monkeypatch, caplog):
    def refuse(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    ran = []
    with caplog.at_level(logging.WARNING, logger=tracing.logger.name):
        with tracing.device_trace(str(tmp_path / "traces")):
            ran.append(True)
    assert ran == [True]
    assert not (tmp_path / "traces").exists()
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "device_trace unavailable" in warnings[0].getMessage()


def test_device_trace_is_a_noop_when_the_profiler_cannot_stop(tmp_path, monkeypatch, caplog):
    real = torch.profiler.profile

    class StopFails(real):
        def stop(self):
            super().stop()
            raise RuntimeError("stop failed")

    monkeypatch.setattr(torch.profiler, "profile", StopFails)
    with caplog.at_level(logging.WARNING, logger=tracing.logger.name):
        with tracing.device_trace(str(tmp_path / "traces")):
            pass
    assert not list((tmp_path / "traces").glob("trace-*.json"))
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "stop_trace failed" in warnings[0].getMessage()


def test_device_trace_lets_the_block_raise(tmp_path):
    try:
        with tracing.device_trace(str(tmp_path / "traces")):
            raise ValueError("from the block")
    except ValueError as e:
        assert str(e) == "from the block"
    else:
        raise AssertionError("the block's exception was swallowed")
