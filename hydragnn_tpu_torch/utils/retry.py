"""Retry with jittered backoff for transient I/O (port of
``utils/retry.py``).

A read off a shared filesystem may fail with a transient ``OSError`` and
succeed on the next attempt. :func:`retry_io` wraps one read with bounded
exponential backoff plus jitter, so that workers that hit the same hiccup
do not retry in step.

Knobs (the environment over the argument defaults):
- ``HYDRAGNN_IO_RETRIES``: attempts in all, default 3 (1: no retry);
- ``HYDRAGNN_IO_RETRY_BASE_S``: the first backoff in seconds, default 0.05.

Only ``OSError`` is retried, and not ``FileNotFoundError``: a missing
file is not transient. Everything else propagates at once.
"""

import os
import random
import time


def backoff_delay(attempt: int, base_delay: float) -> float:
    """The delay before retry ``attempt`` (0-based): ``base * 2^attempt``
    times a uniform ``1 + [0, 0.5)`` jitter."""
    return base_delay * (2.0 ** attempt) * (1.0 + random.uniform(0.0, 0.5))


def retry_io(fn, *, what: str = "", attempts=None, base_delay=None):
    """Call ``fn()``; on a transient ``OSError`` retry with backoff.
    Raises the last error once the attempts are spent."""
    if attempts is None:
        attempts = int(os.getenv("HYDRAGNN_IO_RETRIES", "3"))
    if base_delay is None:
        base_delay = float(os.getenv("HYDRAGNN_IO_RETRY_BASE_S", "0.05"))
    attempts = max(int(attempts), 1)
    last = None
    for i in range(attempts):
        try:
            return fn()
        except FileNotFoundError:
            raise  # a wrong path is not transient
        except OSError as e:
            last = e
            if i == attempts - 1:
                break
            time.sleep(backoff_delay(i, base_delay))
    raise last
