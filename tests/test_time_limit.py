"""The per-test time limit (``tests/_time_limit.py``, armed by
``tests/conftest.py``): it fails what runs past it, it puts back the
``SIGALRM`` handler and interval timer that were in force before, and the
marks that ``tests/conftest.py`` sets by node ID reach ``-m slow``."""

import os
import signal
import subprocess
import sys
import time

import pytest

from _time_limit import DEFAULT_TIME_LIMIT, time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_sigalrm = pytest.mark.skipif(not hasattr(signal, "SIGALRM"), reason="the limit needs SIGALRM")


@pytest.mark.time_limit(1)
def _sleep_in_a_loop():
    while True:
        time.sleep(0.01)


@needs_sigalrm
def test_a_function_past_its_limit_fails_with_the_limits_message():
    (mark,) = _sleep_in_a_loop.pytestmark
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"^exceeded its 1 s limit$"):
        with time_limit(*mark.args):
            _sleep_in_a_loop()
    assert 1.0 <= time.monotonic() - t0 < 2.0


@needs_sigalrm
def test_the_handler_and_timer_in_force_before_are_in_force_after():
    hooks_handler = signal.getsignal(signal.SIGALRM)
    hooks_timer = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < hooks_timer[0] <= DEFAULT_TIME_LIMIT  # this test's own limit is armed

    def before(signum, frame):
        pass

    signal.signal(signal.SIGALRM, before)
    signal.setitimer(signal.ITIMER_REAL, 100.0, 50.0)
    try:
        with time_limit(1):
            assert signal.getsignal(signal.SIGALRM) is not before
            assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 1.0
        assert signal.getsignal(signal.SIGALRM) is before
        delay, interval = signal.getitimer(signal.ITIMER_REAL)
        assert 99.0 < delay <= 100.0 and interval == 50.0
    finally:
        signal.setitimer(signal.ITIMER_REAL, *hooks_timer)
        signal.signal(signal.SIGALRM, hooks_handler)


def test_marks_set_by_node_id_select_the_slow_tests():
    files = ["tests/distributed/test_scaling_harness.py", "tests/distributed/test_multiprocess.py"]
    r = subprocess.run(
        [sys.executable, "-m", "pytest", *files, "--collect-only", "-q", "-m", "slow",
         "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    listed = {line for line in r.stdout.splitlines() if "::" in line}
    assert listed == {
        "tests/distributed/test_scaling_harness.py::test_scaling_harness_smoke",
        "tests/distributed/test_multiprocess.py::test_two_process_cmd_ba_matches_single_process",
        "tests/distributed/test_multiprocess.py::test_two_process_distributed_psum",  # marked in its file
    }
