"""Test-run hooks for the whole repository: a time limit on every test, and
the tests that the tier-1 run (``-m 'not slow'``) leaves out.

Every test's setup and call phases each run under :data:`TIME_LIMIT_S`: a
test that runs past it fails and names itself instead of eating the whole
run's clock.  A test marked ``slow`` (the tests of :data:`SLOW`) runs with
no limit; run those with ``-m slow``.  Under ``--dist loadfile`` the longest
files go to the workers first (:data:`FILE_SECONDS`).
"""

import faulthandler
import hashlib
import os
import signal
import tempfile
import threading
import time
from contextlib import contextmanager

import pytest

#: Seconds each of a test's setup and call phases may take: over three times
#: the slowest test of the tier-1 run, cold.
TIME_LIMIT_S = 450.0
#: A Python signal handler cannot run while the main thread is inside C++
#: (an XLA compile): this long past the limit, every thread's stack is
#: dumped to stderr and the process ends (under xdist: the worker, which
#: xdist reports as crashed on this test and replaces).
TIME_LIMIT_GRACE_S = 60.0

#: Tests marked ``slow``, by node id: each too long for the tier-1 run.
SLOW = {
    # XLA:CPU compiles the jitted double-float lift of the whole five-field
    # evaluation for about half an hour on 8 cores, longer than the whole
    # tier-1 run may take.
    "tests/test_df_lift.py::test_df_lift_is_jittable_and_no_passthrough",
}

#: Worker-seconds of the test files of a minute or more in the tier-1 run
#: (``-n 6 --dist loadfile``, cold, 8 cores; junit times, CHANGES.md).  The
#: files go to the workers longest first, the rest after them in collection
#: order: xdist's own order, by number of tests, starts the long files of few
#: tests last, where they hold up the run's end.
FILE_SECONDS = {
    "test_three_d_model.py": 782,
    "test_torch_simulate.py": 543,
    "test_torch_slice.py": 453,
    "test_torch_three_d.py": 452,
    "test_gradients.py": 436,
    "test_newton_residuals.py": 351,
    "test_mixed_precision.py": 322,
    "test_torch_mixed.py": 270,
    "test_torch_parallel.py": 262,
    "test_torch_batched.py": 249,
    "test_parallel.py": 238,
    "test_torch_golden.py": 204,
    "test_studies_and_plotting.py": 139,
    "test_torch_kernels.py": 135,
    "test_parity_golden.py": 134,
    "test_reghcs_eta_sweep.py": 115,
    "test_three_d_direct_solve.py": 115,
    "test_simulate.py": 107,
    "test_integration_orders.py": 83,
    "test_pallas_kernels.py": 82,
    "test_adaptive.py": 77,
    "test_direct_solve.py": 73,
    "test_three_d.py": 63,
    "test_fe_and_h1_accuracy.py": 62,
}

_stderr_fd = None


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # before ``-m`` deselects
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
    # stable: each file's tests stay together and in their order
    items.sort(key=lambda item: -FILE_SECONDS.get(item.path.name, 0))


def pytest_configure(config):
    # xdist hands the files out in the order above, not by number of tests
    if getattr(config.option, "dist", None) == "loadfile":
        config.option.loadscopereorder = False
    # Capture is suspended here, so fd 2 is the real stderr; during a test it
    # is redirected to a capture file that a dying process never reads back.
    global _stderr_fd
    _stderr_fd = os.dup(2)


def pytest_unconfigure(config):
    global _stderr_fd
    if _stderr_fd is not None:
        os.close(_stderr_fd)
        _stderr_fd = None


@contextmanager
def time_limit(what, seconds):
    """Fail ``what`` with :func:`pytest.fail` once ``seconds`` have passed,
    and end the process ``TIME_LIMIT_GRACE_S`` later; restore the previous
    SIGALRM handler and ITIMER_REAL timer on exit.  A no-op where SIGALRM
    does not exist or off the main thread."""
    if not hasattr(signal, "SIGALRM") or threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{what} ran past its time limit of {seconds:g} s")

    previous = signal.signal(signal.SIGALRM, expire)
    prev_delay, prev_interval = signal.setitimer(signal.ITIMER_REAL, seconds)
    start = time.monotonic()
    faulthandler.dump_traceback_later(
        seconds + TIME_LIMIT_GRACE_S, exit=True,
        file=_stderr_fd if _stderr_fd is not None else 2,
    )
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, signal.SIG_DFL if previous is None else previous)
        if prev_delay:
            left = prev_delay - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3), prev_interval)


def _crash_marker(item):
    """A file that exists while ``item`` runs under its limit in an xdist
    worker.  xdist's loadfile scheduler hands a crashed worker's file to a
    new worker with the crashed test still pending, so a test that ended its
    worker would end every worker that takes the file up; a marker left
    behind by a dead worker stops that.  None outside xdist, where the
    process that ends is the whole run."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return None
    name = hashlib.sha1(item.nodeid.encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(), f"pytest-time-limit-{run}-{name}")


@contextmanager
def _limited_phase(item, what):
    if item.get_closest_marker("slow"):
        yield
        return
    marker = _crash_marker(item)
    if marker is not None:
        if os.path.exists(marker):
            os.remove(marker)
            pytest.fail(f"{what} ended an earlier worker (time limit or crash); not run again")
        open(marker, "w").close()
    try:
        with time_limit(what, TIME_LIMIT_S):
            yield
    finally:
        if marker is not None:
            os.remove(marker)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _limited_phase(item, f"{item.nodeid} (setup)"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited_phase(item, item.nodeid):
        return (yield)
