"""A time limit for a block of test code, armed through ``SIGALRM``.

``tests/conftest.py`` puts every phase of every test under ``time_limit``:
``DEFAULT_TIME_LIMIT`` seconds, or the test's own
``@pytest.mark.time_limit(seconds)``.
"""

import contextlib
import signal
import threading
import time

import pytest

DEFAULT_TIME_LIMIT = 300  # seconds each of a test's setup, call and teardown may take


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the code inside with ``exceeded its {seconds} s limit`` once
    ``seconds`` have passed.

    Arms ``SIGALRM`` through ``ITIMER_REAL`` and puts the handler and the
    timer that were in force back afterwards. The handler runs between
    Python bytecodes, so code stuck inside one C call (an XLA compile, a
    blocking read) fails when that call returns. Does nothing where
    ``SIGALRM`` does not exist or off the main thread.
    """
    if not hasattr(signal, "SIGALRM") or threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"exceeded its {seconds} s limit", pytrace=False)

    start = time.monotonic()
    old_handler = signal.signal(signal.SIGALRM, expire)
    old_delay, old_interval = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)
        if old_delay:
            left = max(old_delay - (time.monotonic() - start), 1e-6)
            signal.setitimer(signal.ITIMER_REAL, left, old_interval)
