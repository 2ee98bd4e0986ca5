"""Logging utilities.

Counterpart of video_llava_tpu/utils/logging.py. Parity: reference
video_chatgpt/utils.py:16-119 — build_logger with a rotating file
handler that also captures stdout/stderr, StreamToLogger, and the OpenAI
moderation check hook.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
from typing import Optional

from video_llava_tpu_torch.constants import LOGDIR

handler: Optional[logging.Handler] = None


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    global handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    stdout_logger = logging.getLogger("stdout")
    stdout_logger.setLevel(logging.INFO)
    sys.stdout = StreamToLogger(stdout_logger, logging.INFO)

    stderr_logger = logging.getLogger("stderr")
    stderr_logger.setLevel(logging.ERROR)
    sys.stderr = StreamToLogger(stderr_logger, logging.ERROR)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        filename = os.path.join(LOGDIR, logger_filename)
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True)
        handler.setFormatter(formatter)
        for item in logging.root.manager.loggerDict.values():
            if isinstance(item, logging.Logger):
                item.addHandler(handler)
    return logger


class StreamToLogger:
    """Fake stream that redirects writes to a logger
    (reference utils.py:59-89)."""

    def __init__(self, logger: logging.Logger, log_level: int = logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp_linebuf = self.linebuf + buf
        self.linebuf = ""
        for line in temp_linebuf.splitlines(True):
            if line[-1] == "\n":
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf != "":
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def violates_moderation(text: str, api_key: Optional[str] = None) -> bool:
    """OpenAI moderation check (reference utils.py:101-119); returns
    False when no key is configured, without a request."""
    import json
    import urllib.request

    api_key = api_key or os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    url = os.environ.get(
        "OPENAI_MODERATION_URL", "https://api.openai.com/v1/moderations")
    text = text.replace("\n", "")
    req = urllib.request.Request(
        url,
        data=json.dumps({"input": text}).encode(),
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {api_key}"},
    )
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            data = json.loads(resp.read())
        return bool(data["results"][0]["flagged"])
    except Exception:  # noqa: BLE001 — the reference's behaviour
        return False


def pretty_print_semaphore(semaphore):
    if semaphore is None:
        return "None"
    return f"Semaphore(value={semaphore._value}, locked={semaphore.locked()})"
