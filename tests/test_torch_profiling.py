"""The port's profiling helpers (``vaeunet_tpu_torch/utils/profiling.py``,
the counterparts of ``vaeunet_tpu/utils/profiling.py:26-107``) on the CPU:
device memory is None without a card and ``memory_allocated`` with one;
``time_fn`` ends each window in its fetch; ``track_memory`` and
``log_memory_usage`` log what the JAX ones log; ``trace`` writes a Chrome
trace.  The card's side runs in ``chip_smoke.py`` phase 16."""

import json
import logging
import re

import pytest
import torch

from vaeunet_tpu.utils import profiling as jax_profiling

from vaeunet_tpu_torch.utils import profiling


def test_device_memory_is_none_on_the_cpu(monkeypatch):
    assert profiling.device_memory_mb("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_mb() is None


def test_device_memory_reads_memory_allocated(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device: seen.append(device) or 5_000_000)
    assert profiling.device_memory_mb() == 5.0
    assert profiling.device_memory_mb("cuda:1") == 5.0
    assert seen == [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("iters,warmup", [(1, 0), (3, 2), (10, 2)])
def test_time_fn_ends_each_window_in_its_fetch(iters, warmup):
    calls, fetched = [], []

    def fn(x, scale=1.0):
        calls.append(x)
        return {"out": (torch.full((2,), x * scale),)}

    t = profiling.time_fn(fn, 3.0, iters=iters, warmup=warmup, scale=2.0,
                          fetch=lambda out: fetched.append(out["out"][0][0].item()))
    assert t >= 0.0 and len(calls) == iters + warmup
    assert fetched == [6.0] * (2 if warmup else 1)


def test_time_fn_default_fetch_reads_the_first_tensor():
    assert profiling.time_fn(lambda: (None, {"a": torch.ones(3)}), iters=2, warmup=1) >= 0.0
    assert profiling.time_fn(lambda: None, iters=1, warmup=1) >= 0.0


def _messages(caplog):
    return [r.getMessage() for r in caplog.records]


def test_track_memory_logs_as_the_jax_one(caplog):
    """The same line, host RSS before and after (no device part on the
    CPU), around the same call; the wrapped function's name and result."""
    def work(n):
        return sum(range(n))

    with caplog.at_level(logging.INFO):
        assert profiling.track_memory(work)(10) == 45
        assert jax_profiling.track_memory(work)(10) == 45
    ours, theirs = _messages(caplog)[-2:]
    shape = re.compile(r"^\[work\] \d+\.\d\ds, host RSS \d+->\d+MB$")
    assert shape.match(ours) and shape.match(theirs), (ours, theirs)
    assert profiling.track_memory(work).__name__ == "work"


def test_log_memory_usage(caplog):
    with caplog.at_level(logging.INFO):
        profiling.log_memory_usage("after load:")
    assert re.match(r"^after load: host RSS \d+MB$", _messages(caplog)[-1])


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as path:
        torch.mm(torch.rand(64, 64), torch.rand(64, 64))
    events = json.loads(open(path).read())["traceEvents"]
    assert path == str(tmp_path / "t" / "trace.json")
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="inside"):
        with profiling.trace(str(tmp_path)) as path:
            raise RuntimeError("inside")
    assert json.loads(open(path).read())["traceEvents"] is not None
