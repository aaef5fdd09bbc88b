"""A wall-clock limit for a test (a helper of the test files; it holds
no test): `limit_each_test(seconds)` returns an autouse fixture that
fails a test of the module past `seconds` with TimeoutError, raised in
the main thread by SIGALRM, so one hung test cannot hold the whole run.
"""

from __future__ import annotations

import contextlib
import signal

import pytest


@contextlib.contextmanager
def time_limit(seconds: float, what: str = "the test"):
    def expire(_signum, _frame):
        raise TimeoutError(f"{what} ran past its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def limit_each_test(seconds: float):
    @pytest.fixture(autouse=True)
    def _time_limit(request):
        with time_limit(seconds, request.node.nodeid):
            yield

    return _time_limit
