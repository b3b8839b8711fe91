"""The test runs' own hooks (the repository's ``conftest.py``): every test
fails once it runs past its time limit and names itself, a test stuck where
no signal handler runs ends its xdist worker without ending the rest of its
file, the previous alarm comes back after a limited block, and the tests of
``SLOW`` are what ``-m slow`` selects."""

import importlib.util
import pathlib
import signal
import subprocess
import sys
import textwrap

import pytest

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_HOOKS = _ROOT / "conftest.py"
_no_alarm = pytest.mark.skipif(
    not hasattr(signal, "SIGALRM"), reason="the time limit needs SIGALRM"
)


def _hooks_with(**constants):
    """The hooks' source with the given module constants set anew."""
    text = _HOOKS.read_text()
    for name, value in constants.items():
        line = next(l for l in text.splitlines() if l.startswith(f"{name} = "))
        text = text.replace(line, f"{name} = {value!r}")
    return text


def _run_inner_suite(tmp_path, conftest_text, test_text, *args):
    """Run one test file under ``conftest_text`` in a fresh pytest process,
    bounded by its own timeout."""
    (tmp_path / "conftest.py").write_text(conftest_text)
    (tmp_path / "test_inner.py").write_text(textwrap.dedent(test_text))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-W", "ignore::pytest.PytestUnknownMarkWarning",
         *args, "test_inner.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )


@_no_alarm
def test_time_limit_fails_a_test_that_runs_past_it(tmp_path):
    proc = _run_inner_suite(tmp_path, _hooks_with(TIME_LIMIT_S=1.0), """
        import time
        import pytest

        def test_sleeps():
            time.sleep(3)

        @pytest.mark.slow
        def test_slow_runs_without_a_limit():
            time.sleep(3)

        def test_after_it_runs():
            pass
    """)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "test_inner.py::test_sleeps ran past its time limit of 1 s" in proc.stdout, proc.stdout
    assert "1 failed, 2 passed" in proc.stdout, proc.stdout


@_no_alarm
def test_time_limit_ends_a_test_stuck_where_no_handler_runs(tmp_path):
    """With SIGALRM blocked (as if the main thread sat in C++), the
    faulthandler backstop dumps the stack, naming the test, and ends the
    xdist worker once the grace period has passed too.  The new worker that
    takes the file up refuses the stuck test instead of running it again,
    and runs the rest of the file."""
    proc = _run_inner_suite(tmp_path, _hooks_with(TIME_LIMIT_S=1.0, TIME_LIMIT_GRACE_S=1.0), """
        import signal
        import time

        def test_stuck():
            signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGALRM])
            time.sleep(30)

        def test_after_it_runs():
            pass
    """, "-p", "xdist", "-n", "1", "--dist", "loadfile")
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "Timeout (0:00:02)!" in proc.stderr, out
    assert "in test_stuck" in proc.stderr, out
    assert "crashed while running 'test_inner.py::test_stuck'" in proc.stdout, out
    assert "test_inner.py::test_stuck (setup) ended an earlier worker" in proc.stdout, out
    assert "1 passed" in proc.stdout, out


@_no_alarm
def test_time_limit_restores_the_previous_alarm():
    spec = importlib.util.spec_from_file_location("repo_test_hooks", _HOOKS)
    hooks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hooks)

    def mine(signum, frame):
        pass

    outer_handler = signal.signal(signal.SIGALRM, mine)
    outer_timer = signal.setitimer(signal.ITIMER_REAL, 1000.0)
    try:
        with hooks.time_limit("inner", 5.0):
            assert signal.getsignal(signal.SIGALRM) is not mine
            assert 0.0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 5.0
        assert signal.getsignal(signal.SIGALRM) is mine
        assert 990.0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 1000.0
    finally:
        signal.setitimer(signal.ITIMER_REAL, *outer_timer)
        signal.signal(signal.SIGALRM, outer_handler)


def test_slow_selects_the_jitted_double_float_lift():
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-p", "no:cacheprovider",
         "-m", "slow", "tests/test_df_lift.py"],
        cwd=_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    selected = [l for l in proc.stdout.splitlines() if "::" in l]
    assert selected == ["tests/test_df_lift.py::test_df_lift_is_jittable_and_no_passthrough"], proc.stdout
