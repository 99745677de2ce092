"""The port's utilities (trace_tpu_torch/utils) against the JAX package's:
``logging`` (the line-buffered stream logger, the shared rotating file
handler, the process-0 print), ``moderation`` (the pluggable fail-open hook,
tests/test_moderation.py's cases on both), ``profiling``'s ``StepTimer``
(the same summary keys) and ``trace`` (a Chrome trace written on the CPU)."""

import json
import logging

import pytest
import torch

from trace_tpu.utils import logging as jlogging
from trace_tpu.utils import moderation as jmoderation
from trace_tpu.utils import profiling as jprofiling
from trace_tpu_torch.utils import logging as tlogging
from trace_tpu_torch.utils import moderation as tmoderation
from trace_tpu_torch.utils import profiling as tprofiling


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.seen = []

    def emit(self, record):
        self.seen.append((record.levelno, record.getMessage()))


@pytest.mark.parametrize("writes", [
    ["one line\n"],
    ["par", "tial ", "line\nand more", "\n", "last"],
    ["a\nb\n\nc\r\nd", ""],
])
def test_stream_to_logger_matches_jax(writes):
    """The same writes give the same records, a line at a time; the partial
    last line waits for ``flush``; other attributes come from stdout."""
    records = {}
    for name, mod in (("jax", jlogging), ("port", tlogging)):
        logger = logging.getLogger(f"test_stream_{name}")
        logger.propagate = False
        logger.setLevel(logging.DEBUG)
        handler = _Records()
        logger.addHandler(handler)
        try:
            stream = mod.StreamToLogger(logger, logging.WARNING)
            for w in writes:
                stream.write(w)
            before_flush = list(handler.seen)
            stream.flush()
            records[name] = (before_flush, handler.seen, stream.linebuf)
            assert stream.encoding == stream.terminal.encoding
        finally:
            logger.removeHandler(handler)
    assert records["port"] == records["jax"]
    assert all(level == logging.WARNING for level, _ in records["port"][1])


def test_build_logger_shares_one_rotating_file(tmp_path, monkeypatch):
    """The first ``build_logger`` opens LOGDIR/<file> and adds it to every
    logger; a message reaches the file as the JAX package formats it."""
    root = logging.getLogger()
    formatters = [(h, h.formatter) for h in root.handlers]
    handlers = []
    try:
        for name, mod in (("jax", jlogging), ("port", tlogging)):
            monkeypatch.setattr(mod, "LOGDIR", str(tmp_path / name))
            monkeypatch.setattr(mod, "_handler", None)
            logger = mod.build_logger(f"test_build_{name}", "server.log")
            handlers.append(mod._handler)
            assert logger.level == logging.INFO
            assert mod.build_logger(f"test_build_{name}_2", "other.log") is not logger
            assert mod._handler is handlers[-1]  # opened once
            logger.info("hello %s", 3)
            mod._handler.flush()
        lines = {name: (tmp_path / name / "server.log").read_text().splitlines()
                 for name in ("jax", "port")}
        assert not (tmp_path / "port" / "other.log").exists()
        strip = lambda ls: [ln.split(" | ", 1)[1].replace("test_build_port", "test_build_jax")
                            for ln in ls if "hello" in ln]
        assert strip(lines["port"]) == strip(lines["jax"]) == [
            "INFO | test_build_jax | hello 3"]
    finally:
        for h in handlers:
            for item in logging.root.manager.loggerDict.values():
                if isinstance(item, logging.Logger) and h in item.handlers:
                    item.removeHandler(h)
            h.close()
        for h, f in formatters:
            h.setFormatter(f)


def test_rank0_print_prints_in_one_process(capsys):
    tlogging.rank0_print("only", "rank", 0, sep="-")
    assert capsys.readouterr().out == "only-rank-0\n"


@pytest.mark.parametrize("mod", [jmoderation, tmoderation], ids=["jax", "port"])
def test_moderation_fails_open(mod):
    """tests/test_moderation.py's cases, on both packages."""
    try:
        assert mod.violates_moderation("anything") is False
        mod.set_moderation_backend(lambda t: "bad" in t)
        assert mod.violates_moderation("this is bad") is True
        assert mod.violates_moderation("fine") is False
        seen = []
        mod.set_moderation_backend(lambda t: seen.append(t) or False)
        mod.violates_moderation("two\nlines")
        assert seen == ["twolines"]

        def boom(t):
            raise RuntimeError("network down")

        mod.set_moderation_backend(boom)
        assert mod.violates_moderation("whatever") is False
    finally:
        mod.set_moderation_backend(None)


def test_step_timer_summary_matches_jax():
    """The same sections give the same summary keys and counts; ``sync``
    takes a CPU tensor (no wait), a list and a dict of them."""
    import jax.numpy as jnp

    timers = {"jax": jprofiling.StepTimer(), "port": tprofiling.StepTimer()}
    syncs = {"jax": [jnp.ones(3), None, [jnp.zeros(2)]],
             "port": [torch.ones(3), None, {"a": [torch.zeros(2)]}]}
    for name, timer in timers.items():
        for i, sync in enumerate(syncs[name]):
            with timer("encode" if i < 2 else "decode", sync=sync):
                sum(range(1000))
    got, want = timers["port"].summary(), timers["jax"].summary()
    assert list(got) == list(want) == ["encode", "decode"]
    for section in want:
        assert list(got[section]) == list(want[section]) == ["total_s", "count", "mean_s"]
        assert got[section]["count"] == want[section]["count"]
        assert got[section]["total_s"] >= 0 and got[section]["mean_s"] >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprofiling.trace(str(tmp_path / "prof")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert log_dir == str(tmp_path / "prof") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
