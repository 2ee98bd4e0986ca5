"""Minimal OpenAI-compatible chat-completions client over urllib.

Counterpart of video_llava_tpu/eval/openai_client.py, speaking HTTP
through the standard library (urllib.request) instead of `requests`:
per-request exponential backoff on 429/5xx and connection errors
(honoring Retry-After) and an optional client-side request-rate cap.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

RETRYABLE_STATUS = {429, 500, 502, 503, 504}


class RateLimiter:
    """Thread-safe minimum-interval limiter (requests per second)."""

    def __init__(self, requests_per_second: float):
        self.min_interval = 1.0 / requests_per_second
        self._lock = threading.Lock()
        self._next_slot = 0.0

    def acquire(self):
        with self._lock:
            now = time.monotonic()
            wait = self._next_slot - now
            self._next_slot = max(self._next_slot, now) + self.min_interval
        if wait > 0:
            time.sleep(wait)


class ChatCompletionClient:
    def __init__(self, api_base: Optional[str] = None,
                 api_key: Optional[str] = None, timeout: float = 120.0,
                 max_retries: int = 5, backoff_base: float = 1.0,
                 backoff_max: float = 30.0,
                 requests_per_second: Optional[float] = None,
                 sleep=time.sleep):
        self.api_base = (api_base or os.environ.get("OPENAI_API_BASE")
                         or "http://localhost:8000/v1").rstrip("/")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "EMPTY")
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.rate_limiter = (RateLimiter(requests_per_second)
                             if requests_per_second else None)
        self._sleep = sleep  # injectable for tests

    def _backoff_seconds(self, attempt: int, resp) -> float:
        if resp is not None:
            retry_after = resp.headers.get("Retry-After")
            if retry_after:
                try:
                    return min(float(retry_after), self.backoff_max)
                except ValueError:
                    pass
        return min(self.backoff_base * (2.0 ** attempt), self.backoff_max)

    def create(self, model: str, messages: List[Dict[str, str]],
               temperature: float = 0.2, max_tokens: int = 512, **kw) -> dict:
        body = json.dumps({"model": model, "messages": messages,
                           "temperature": temperature,
                           "max_tokens": max_tokens, **kw}).encode()
        last_exc = None
        for attempt in range(self.max_retries + 1):
            if self.rate_limiter is not None:
                self.rate_limiter.acquire()
            resp = None
            req = urllib.request.Request(
                f"{self.api_base}/chat/completions", data=body, method="POST",
                headers={"Authorization": f"Bearer {self.api_key}",
                         "Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:  # a status: retry 429/5xx
                if e.code not in RETRYABLE_STATUS:
                    raise
                last_exc, resp = e, e
            except (urllib.error.URLError, OSError) as e:  # no response
                last_exc = e
            if attempt < self.max_retries:
                self._sleep(self._backoff_seconds(attempt, resp))
        raise last_exc

    def chat_text(self, model: str, messages: List[Dict[str, str]],
                  **kw) -> str:
        out = self.create(model, messages, **kw)
        return out["choices"][0]["message"]["content"]
