"""Elastic supervision of long calibrations on CUDA devices.

Port of calamity_tpu/supervisor.py. A full-array many-poltime batched
descent runs for hours, and the device or the NCCL communicator under it
can die: an uncorrectable ECC error, a GPU that falls off the bus, a peer
rank whose loss aborts the communicator. A CUDA context that has seen such
an error cannot be used again in its process, so the recovery domain is
the process: the checkpointed drivers persist the whole descent state every
``checkpoint_every`` steps and resume bit for bit, and the supervisor runs
the calibration command as a child process, classifies its failures, waits
until a tiny probe in a fresh subprocess reaches the device again, and
relaunches; the relaunched child resumes from the latest checkpoint
(``resume`` defaults to True in every driver).

Usage:
    python -m calamity_tpu_torch.supervisor [options] -- \\
        python scripts/calibrate_and_model_dpss_torch.py --time_parallel \\
            --checkpoint_dir /ckpt ...

or, for a run over several GPUs, around the launcher:
    python -m calamity_tpu_torch.supervisor -- torchrun --nproc_per_node=4 \\
        scripts/calibrate_and_model_dpss_torch.py --time_parallel --checkpoint_dir /ckpt ...

The supervised command must be resume-safe (``--checkpoint_dir`` set). The
supervisor never initializes CUDA itself, so it holds no context of its own
on the device; its probes run in short-lived subprocesses, which a wedged
device can hang and the timeout then abandons.
"""

from __future__ import annotations

import datetime
import subprocess
import sys
import time

# appended to the captured tail when the supervisor kills a silent child
HANG_MARKER = "supervisor: child produced no output"

# Failure signatures that say the device or the link between devices died
# under the child: retryable once the device answers probes again. Anything
# else (a Python exception, a bad flag, an illegal memory access, which is
# a program error) is a real failure and surfaces at once.
TRANSIENT_PATTERNS = (
    # the driver no longer gives the process a context on the card: it was
    # reset, taken by another process in exclusive mode, or is recovering
    "CUDA-capable device(s) is/are busy or unavailable",
    # a double-bit memory error: the card's state is lost, a reset (and a
    # relaunch from the checkpoint) recovers it
    "uncorrectable ECC error encountered",
    # the GPU fell off the PCIe / NVLink fabric (NVML's word for it)
    "GPU is lost",
    # a peer's device or the fabric failed: NCCL's watchdog times out the
    # stuck collective or aborts the communicator, and every rank of the
    # job dies with one of these
    "Watchdog caught collective operation timeout",
    "NCCL communicator was aborted",
    # NCCL's own transport (sockets, IB, shared memory) failed
    "ncclSystemError",
    HANG_MARKER,
)

# Failure signatures retried at most once per supervised run: device memory
# exhausted right after a device failure can be residue of the dead
# process's allocations that the driver has not freed yet, rather than a
# fit that does not fit. One relaunch (from the checkpoint) tells them
# apart; a second such failure is real and surfaces.
RETRY_ONCE_PATTERNS = ("torch.OutOfMemoryError", "CUDA out of memory")

# classification reads only the end of the output: the fatal error is the
# last thing a dying child prints, while recovered warnings can sit anywhere
# earlier in a long run's log without making its final error retryable
CLASSIFY_TAIL_BYTES = 8192

# a tiny matmul on the card and a fetch of its result to the host; distinct
# inputs each time
_PROBE_SRC = """
import time, torch
x = torch.full((128, 128), float(time.time() % 1000.0), device="cuda")
print(float(torch.sum(x @ x).cpu()))
"""


def is_transient_device_failure(text: str) -> bool:
    """Whether the END of the captured child output names a retryable
    device failure (vs a genuine program error)."""
    tail = text[-CLASSIFY_TAIL_BYTES:]
    return any(p in tail for p in TRANSIENT_PATTERNS)


def is_retry_once_failure(text: str) -> bool:
    """Whether the END of the captured child output names a failure worth
    exactly one relaunch (see RETRY_ONCE_PATTERNS)."""
    tail = text[-CLASSIFY_TAIL_BYTES:]
    return any(p in tail for p in RETRY_ONCE_PATTERNS)


def probe_device(timeout_s: float = 180.0) -> bool:
    """Run a tiny CUDA matmul and fetch its result in a fresh subprocess.

    The fetch to the host is the completion criterion. Returns False on a
    nonzero exit or on timeout (a wedged device hangs probes rather than
    refusing them)."""
    try:
        res = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            timeout=timeout_s,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        return res.returncode == 0
    except subprocess.TimeoutExpired:
        return False


def wait_for_device(
    max_wait_s: float = 3600.0,
    interval_s: float = 60.0,
    probe_timeout_s: float = 180.0,
    probe_fn=None,
    echo=print,
    sleep_fn=time.sleep,
) -> bool:
    """Poll until the device answers, up to ``max_wait_s`` of waiting."""
    probe_fn = probe_fn or (lambda: probe_device(probe_timeout_s))
    deadline = time.monotonic() + max_wait_s
    attempt = 0
    while True:
        attempt += 1
        t0 = time.monotonic()
        if probe_fn():
            echo(f"{datetime.datetime.now()} device answering (attempt {attempt})")
            return True
        if time.monotonic() >= deadline:
            return False
        echo(
            f"{datetime.datetime.now()} device unresponsive "
            f"(attempt {attempt}); retrying in {interval_s:.0f}s"
        )
        # count time spent inside the hung probe toward the interval
        sleep_fn(max(0.0, interval_s - (time.monotonic() - t0)))


def run_supervised(
    argv,
    max_restarts: int = 10,
    max_wait_s: float = 3600.0,
    interval_s: float = 60.0,
    probe_timeout_s: float = 180.0,
    tail_bytes: int = 65536,
    hang_timeout_s: float | None = 3600.0,
    probe_fn=None,
    echo=print,
    sleep_fn=time.sleep,
    run_fn=None,
    poll_s: float = 5.0,
) -> int:
    """Run ``argv`` until it exits 0, restarting on transient device death.

    The child's stdout/stderr stream through to this process's stdout; the
    last ``tail_bytes`` are kept for failure classification. Non-transient
    failures return the child's exit code at once. Returns 0 on success,
    the last exit code when restarts are exhausted or the device never
    comes back.

    ``hang_timeout_s``: a wedged device or a stuck collective hangs the
    child rather than failing it, so a child that prints nothing for this
    long is killed and treated as a transient device failure. Size it above
    the longest silent phase of a healthy run; ``None`` disables it.

    ``probe_fn``/``run_fn``/``sleep_fn``/``poll_s`` exist for tests
    (fakes, and a short liveness poll so the hang tests run in seconds)."""

    def default_run(argv):
        import os
        import threading

        # unbuffered child stdout: liveness is measured by bytes arriving on
        # this pipe, and a block-buffered child (Python's default when
        # piped) can hold sparse progress echoes in its stdio buffer past
        # hang_timeout_s, so a healthy run would be killed as wedged
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        proc = subprocess.Popen(
            list(argv), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        state = {"tail": b"", "last": time.monotonic()}
        lock = threading.Lock()

        def pump():
            # read1, not lines: any bytes count as liveness, so a child
            # whose only output is \r-updated progress is not killed
            while True:
                chunk = proc.stdout.read1(65536)
                if not chunk:
                    break
                sys.stdout.buffer.write(chunk)
                sys.stdout.buffer.flush()
                with lock:
                    state["tail"] = (state["tail"] + chunk)[-tail_bytes:]
                    state["last"] = time.monotonic()

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()
        hung = False
        while True:
            try:
                proc.wait(timeout=poll_s)
                break
            except subprocess.TimeoutExpired:
                pass
            if hang_timeout_s is not None:
                with lock:
                    silent = time.monotonic() - state["last"]
                if silent >= hang_timeout_s:
                    hung = True
                    echo(
                        f"{datetime.datetime.now()} {HANG_MARKER} for "
                        f"{silent:.0f}s; killing it (assumed wedged device)"
                    )
                    proc.kill()
                    proc.wait()
                    break
        reader.join(timeout=10.0)
        tail = state["tail"].decode("utf-8", errors="replace")
        if hung:
            # transient: the device probe decides when to relaunch
            tail += f"\n{HANG_MARKER} (killed after {hang_timeout_s:.0f}s)\n"
        return proc.returncode, tail

    run_fn = run_fn or default_run
    restarts = 0
    retry_once_spent = False
    while True:
        echo(
            f"{datetime.datetime.now()} supervisor: launching "
            f"(restart {restarts}/{max_restarts}): {' '.join(map(str, argv))}"
        )
        code, tail = run_fn(argv)
        if code == 0:
            echo(f"{datetime.datetime.now()} supervisor: command succeeded")
            return 0
        if not is_transient_device_failure(tail):
            if (
                not retry_once_spent
                and restarts < max_restarts
                and is_retry_once_failure(tail)
            ):
                retry_once_spent = True
                echo(
                    f"{datetime.datetime.now()} supervisor: device memory "
                    f"exhausted (exit {code}); retrying ONCE (a dead process's "
                    "allocations can linger; a second identical failure is "
                    "treated as real)"
                )
            else:
                echo(
                    f"{datetime.datetime.now()} supervisor: non-transient "
                    f"failure (exit {code}); not retrying"
                )
                return code
        if restarts >= max_restarts:
            echo(
                f"{datetime.datetime.now()} supervisor: transient failure but "
                f"restart budget exhausted ({max_restarts})"
            )
            return code
        restarts += 1
        echo(
            f"{datetime.datetime.now()} supervisor: transient device failure "
            f"(exit {code}); waiting for the device before restart "
            f"{restarts}/{max_restarts}"
        )
        if not wait_for_device(
            max_wait_s=max_wait_s,
            interval_s=interval_s,
            probe_timeout_s=probe_timeout_s,
            probe_fn=probe_fn,
            echo=echo,
            sleep_fn=sleep_fn,
        ):
            echo(
                f"{datetime.datetime.now()} supervisor: device did not return "
                f"within {max_wait_s:.0f}s; giving up"
            )
            return code


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m calamity_tpu_torch.supervisor",
        description="Restart a resume-safe calibration command across "
        "transient CUDA device or NCCL failures (see module docstring).",
    )
    ap.add_argument("--max_restarts", type=int, default=10)
    ap.add_argument("--max_wait", type=float, default=3600.0,
                    help="seconds to wait for the device to answer probes "
                         "after a transient failure")
    ap.add_argument("--probe_interval", type=float, default=60.0)
    ap.add_argument("--probe_timeout", type=float, default=180.0,
                    help="per-probe subprocess timeout (a wedged device hangs "
                         "probes rather than refusing them)")
    ap.add_argument("--hang_timeout", type=float, default=3600.0,
                    help="kill + retry the child if it prints nothing for "
                         "this many seconds (a wedged device or a stuck "
                         "collective hangs it); 0 disables")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command to supervise (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (pass it after --)")
    return run_supervised(
        cmd,
        max_restarts=args.max_restarts,
        max_wait_s=args.max_wait,
        interval_s=args.probe_interval,
        probe_timeout_s=args.probe_timeout,
        hang_timeout_s=args.hang_timeout if args.hang_timeout > 0 else None,
    )


if __name__ == "__main__":
    sys.exit(main())
