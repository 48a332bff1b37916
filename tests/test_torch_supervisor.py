"""The port's run supervisor (calamity_tpu_torch.supervisor): the cases of
tests/test_supervisor.py against it, with fakes for the device probe and
the child runner and CUDA / NCCL failure texts in place of the relay's, plus
the classification of the CUDA and NCCL patterns themselves."""

import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

from calamity_tpu_torch import supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_GONE = ("RuntimeError: CUDA error: CUDA-capable device(s) is/are busy or unavailable\n"
               "CUDA kernel errors might be asynchronously reported")


def _quiet(**kw):
    return dict(dict(echo=lambda *_: None, sleep_fn=lambda *_: None), **kw)


def test_transient_classification():
    assert supervisor.is_transient_device_failure(DEVICE_GONE)
    assert supervisor.is_transient_device_failure(
        "[Rank 1] Watchdog caught collective operation timeout: WorkNCCL(SeqNum=12, "
        "OpType=ALLREDUCE) ran for 600000 milliseconds before timing out."
    )
    assert not supervisor.is_transient_device_failure(
        "ValueError: steps_per_execution bounds the steps of one descent call"
    )
    assert not supervisor.is_transient_device_failure(
        "Traceback (most recent call last): KeyError: 'antenna 7'"
    )


@pytest.mark.parametrize("text, transient", [
    ("torch.AcceleratorError: CUDA error: uncorrectable ECC error encountered", True),
    ("Unable to determine the device handle for GPU0000:19:00.0: GPU is lost.", True),
    ("torch.distributed.DistBackendError: NCCL communicator was aborted on rank 3.", True),
    ("torch.distributed.DistBackendError: NCCL error: unhandled system error "
     "(run with NCCL_DEBUG=INFO for details), NCCL version 2.21.5\nncclSystemError", True),
    # program errors are never transient
    ("RuntimeError: CUDA error: an illegal memory access was encountered", False),
    ("error: unrecognized arguments: --bad_flag", False),
    ("Traceback (most recent call last):\n  File \"x.py\", line 1\nZeroDivisionError", False),
])
def test_cuda_and_nccl_patterns(text, transient):
    assert supervisor.is_transient_device_failure(text) is transient
    assert not supervisor.is_retry_once_failure(text)


def test_out_of_memory_is_retry_once():
    for text in ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB",
                 "RuntimeError: CUDA out of memory."):
        assert supervisor.is_retry_once_failure(text)
        assert not supervisor.is_transient_device_failure(text)


def test_run_supervised_restarts_until_success():
    """Two transient crashes, then success: the supervisor retries through
    both, probing between attempts, and returns 0."""
    attempts, probes = [], []

    def fake_run(argv):
        attempts.append(list(argv))
        if len(attempts) < 3:
            return 1, DEVICE_GONE
        return 0, "done"

    code = supervisor.run_supervised(["cmd", "--flag"], max_restarts=5, run_fn=fake_run,
                                     probe_fn=lambda: probes.append(1) or True, **_quiet())
    assert code == 0
    assert len(attempts) == 3
    assert all(a == ["cmd", "--flag"] for a in attempts)
    assert len(probes) == 2  # one wait_for_device round per restart


def test_out_of_memory_retried_exactly_once():
    """Device memory exhausted is retried once; a second identical failure
    surfaces as real, and a first one that clears on the retry succeeds."""
    oom = "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 20.00 GiB"
    attempts = []

    def fail_twice(argv):
        attempts.append(1)
        return 1, oom

    assert supervisor.run_supervised(["cmd"], max_restarts=5, run_fn=fail_twice,
                                     probe_fn=lambda: True, **_quiet()) == 1
    assert len(attempts) == 2

    attempts.clear()

    def fail_once(argv):
        attempts.append(1)
        return (0, "done") if len(attempts) > 1 else (1, oom)

    assert supervisor.run_supervised(["cmd"], max_restarts=5, run_fn=fail_once,
                                     probe_fn=lambda: True, **_quiet()) == 0
    assert len(attempts) == 2


def test_run_supervised_stops_on_real_failure():
    attempts = []

    def fake_run(argv):
        attempts.append(1)
        return 2, "RuntimeError: CUDA error: an illegal memory access was encountered"

    code = supervisor.run_supervised(["cmd"], max_restarts=5, run_fn=fake_run,
                                     probe_fn=lambda: True, **_quiet())
    assert code == 2
    assert len(attempts) == 1


def test_run_supervised_exhausts_budget():
    code = supervisor.run_supervised(["cmd"], max_restarts=2,
                                     run_fn=lambda argv: (1, DEVICE_GONE),
                                     probe_fn=lambda: True, **_quiet())
    assert code == 1


def test_wait_for_device_gives_up(monkeypatch):
    """An always-dead device exhausts max_wait_s (monotonic time faked)."""
    t = [0.0]

    def fake_monotonic():
        t[0] += 30.0
        return t[0]

    monkeypatch.setattr(supervisor.time, "monotonic", fake_monotonic)
    assert not supervisor.wait_for_device(max_wait_s=120.0, interval_s=10.0,
                                          probe_fn=lambda: False, **_quiet())


def test_end_to_end_subprocess_resume(tmp_path):
    """Real child processes: the command dies with a device signature until
    its state file has counted enough launches, then succeeds (the default
    run_fn: tee and tail capture)."""
    state = tmp_path / "state"
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        p = {str(state)!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        if n + 1 < 3:
            print("step", n + 1)
            sys.stderr.write({DEVICE_GONE!r} + "\\n")
            sys.exit(1)
        print("converged")
    """))
    code = supervisor.run_supervised([sys.executable, "-S", str(script)], max_restarts=5,
                                     probe_fn=lambda: True, **_quiet())
    assert code == 0
    assert state.read_text() == "3"


def test_classification_window_is_the_tail():
    """A recovered failure early in a long log does not make a later
    program error retryable; the same text at the end does."""
    early = DEVICE_GONE + "\n"
    real_error = "Traceback...\nValueError: bad checkpoint structure\n"
    padding = "step log line\n" * 2000  # > CLASSIFY_TAIL_BYTES
    assert not supervisor.is_transient_device_failure(early + padding + real_error)
    assert supervisor.is_transient_device_failure(padding + DEVICE_GONE)


def test_hang_detection_kills_and_retries():
    """A child that goes silent (a wedged device or collective) is killed
    after hang_timeout_s and classified as transient; the relaunch
    succeeds."""
    fd, state = tempfile.mkstemp()
    os.close(fd)
    os.unlink(state)
    script = (
        "import os, sys, time\n"
        f"p = {state!r}\n"
        "first = not os.path.exists(p)\n"
        "open(p, 'w').write('x')\n"
        "if first:\n"
        "    print('starting', flush=True)\n"
        "    time.sleep(600)\n"
        "print('converged', flush=True)\n"
    )
    code = supervisor.run_supervised([sys.executable, "-S", "-c", script], max_restarts=2,
                                     hang_timeout_s=4.0, probe_fn=lambda: True, poll_s=0.2,
                                     **_quiet())
    assert code == 0
    os.unlink(state)


def test_carriage_return_output_counts_as_liveness():
    """Output that is only \\r-updated progress counts as liveness."""
    script = (
        "import sys, time\n"
        "for i in range(8):\n"
        "    sys.stdout.write(f'\\rprogress {i}')\n"
        "    sys.stdout.flush()\n"
        "    time.sleep(0.4)\n"
        "print('\\nconverged', flush=True)\n"
    )
    code = supervisor.run_supervised([sys.executable, "-S", "-c", script], max_restarts=0,
                                     hang_timeout_s=3.0, probe_fn=lambda: True, poll_s=0.2,
                                     **_quiet())
    assert code == 0


def test_unflushed_prints_count_as_liveness():
    """A child that prints without flushing is launched unbuffered, so its
    sparse echoes reach the liveness pipe at once."""
    script = (
        "import time\n"
        "for i in range(8):\n"
        "    print(f'echo {i}')\n"
        "    time.sleep(0.4)\n"
        "print('converged')\n"
    )
    code = supervisor.run_supervised([sys.executable, "-S", "-c", script], max_restarts=0,
                                     hang_timeout_s=3.0, probe_fn=lambda: True, poll_s=0.2,
                                     **_quiet())
    assert code == 0


def test_cli_requires_command():
    with pytest.raises(SystemExit):
        supervisor.main(["--max_restarts", "1"])


def test_cli_passes_through(tmp_path):
    marker = tmp_path / "ran"
    code = supervisor.main(["--max_restarts", "0", "--", sys.executable, "-S", "-c",
                            f"open({str(marker)!r}, 'w').write('y')"])
    assert code == 0
    assert marker.exists()


def test_probe_fails_without_a_card():
    """The probe is a real CUDA matmul in a subprocess: on a machine without
    a card it reports the device as absent."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert supervisor.probe_device(timeout_s=120.0) is False


def test_module_help_runs():
    proc = subprocess.run([sys.executable, "-m", "calamity_tpu_torch.supervisor", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert "transient CUDA device or NCCL failures" in " ".join(proc.stdout.split())
