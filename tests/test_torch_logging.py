"""utils/logging.py against the JAX package's: the same writes (split
lines, a partial line carried over, a flush, an empty flush) through
each package's StreamToLogger give the same records, attribute reads
fall through to the terminal, build_logger swaps sys.stdout/sys.stderr
for StreamToLogger instances and adds one rotating file handler under
LOGDIR, violates_moderation makes no request without a key, and
pretty_print_semaphore prints the same of an asyncio.Semaphore; sys.stdout, sys.stderr, the
handlers and the module globals are restored."""

import io
import logging
import sys
import asyncio

import pytest

from video_llava_tpu.utils import logging as jlog
from video_llava_tpu_torch import constants
from video_llava_tpu_torch.utils import logging as tlog


class Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.got = []

    def emit(self, record):
        self.got.append((record.name, record.levelno, record.getMessage()))


def _drive(module, name):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    rec = Records()
    logger.addHandler(rec)
    terminal = io.StringIO()
    saved = sys.stdout
    sys.stdout = terminal
    try:
        stream = module.StreamToLogger(logger, logging.WARNING)
    finally:
        sys.stdout = saved
    for buf in ("one\n", "two\nthr", "ee\n\n", "tail", "", " more"):
        stream.write(buf)
    stream.flush()
    stream.flush()
    stream.write("a\r\nb\n")
    assert stream.getvalue() == ""  # falls through to the terminal
    logger.removeHandler(rec)
    return [(level, msg) for _, level, msg in rec.got]


def test_logging_matches_jax(tmp_path, monkeypatch):
    want = _drive(jlog, "jax_stream")
    got = _drive(tlog, "port_stream")
    assert got == want
    assert got[:4] == [(logging.WARNING, "one"), (logging.WARNING, "two"),
                       (logging.WARNING, "three"), (logging.WARNING, "")]

    monkeypatch.setattr(tlog, "LOGDIR", str(tmp_path / "logs"))
    monkeypatch.setattr(tlog, "handler", None)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    root = logging.getLogger()
    saved = (sys.stdout, sys.stderr, list(root.handlers),
             [h.formatter for h in root.handlers])
    owners = []
    try:
        logger = tlog.build_logger("port_app", "port.log")
        assert isinstance(sys.stdout, tlog.StreamToLogger)
        assert isinstance(sys.stderr, tlog.StreamToLogger)
        assert sys.stderr.log_level == logging.ERROR
        assert logger.level == logging.INFO
        h = tlog.handler
        assert isinstance(h, logging.handlers.TimedRotatingFileHandler)
        assert h.baseFilename == str(tmp_path / "logs" / "port.log")
        owners = [item for item in logging.root.manager.loggerDict.values()
                  if isinstance(item, logging.Logger) and h in item.handlers]
        assert logger in owners
        logger.info("hello file")
        h.flush()
        assert "| INFO | port_app | hello file" in (
            tmp_path / "logs" / "port.log").read_text()
        again = tlog.build_logger("port_app2", "other.log")
        assert tlog.handler is h and again.name == "port_app2"
    finally:
        sys.stdout, sys.stderr = saved[0], saved[1]
        for item in owners:
            item.removeHandler(tlog.handler)
        if tlog.handler is not None:
            tlog.handler.close()
        root.handlers[:] = saved[2]
        for hd, fmt in zip(saved[2], saved[3]):
            hd.setFormatter(fmt)
    assert constants.LOGDIR == "."

    def no_request(*a, **kw):
        raise AssertionError("no request without a key")

    monkeypatch.setattr("urllib.request.urlopen", no_request)
    assert tlog.violates_moderation("anything") is False
    assert jlog.violates_moderation("anything") is False
    sem = asyncio.Semaphore(2)  # the serving workers' semaphore
    asyncio.run(sem.acquire())
    assert tlog.pretty_print_semaphore(sem) == jlog.pretty_print_semaphore(
        sem) == "Semaphore(value=1, locked=False)"
    assert tlog.pretty_print_semaphore(None) == "None"
    with pytest.raises(AttributeError):
        tlog.StreamToLogger(logging.getLogger("x")).no_such_attribute
