"""What a runner does around a job fn on one of its threads, shared by the
thread runner (``launcher.py``) and the subprocess runner's worker
(``durable/worker.py``): capture the thread's stdout as the job's log, run
the fn on the job's CUDA stream, and read the job's end time once that
stream's work has ended.

It imports no torch: ``torch`` is looked up in ``sys.modules`` and used only
once CUDA is initialised, which a process that never imported torch cannot
have done. So a worker that runs CPU jobs never loads torch, and a CPU-only
process's records are the reference's."""
from __future__ import annotations

import io
import sys
import threading
import time
from contextlib import contextmanager


def cuda():
    """The ``torch`` module once CUDA is initialised in this process, else
    None."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return torch
    return None


def elapsed(t0: float, stream=None, *, quiet: bool = False) -> float:
    """``perf_counter() - t0`` once the work queued on the job's CUDA
    stream has ended. A CUDA launch returns before its kernel runs, so a
    job fn that returns with work still queued would otherwise get the time
    of its launches as its runtime, its bill and the profiler's sample.
    ``stream`` is the stream the job ran on (a stream of its own, see
    ``ThreadPoolRunner`` and the worker), or None for the stream current on
    this thread, which is the one a ``LocalRunner`` job runs on. Only that
    stream is waited for: device work a job puts on a side stream of its own
    (or on another device) without joining it back to its stream is not.
    Only once CUDA is initialised. ``quiet`` (the failure paths) drops an
    error of the wait itself: the job is failing already, and the runner
    must still finalize it."""
    torch = cuda()
    if torch is not None:
        try:
            (stream or torch.cuda.current_stream()).synchronize()
        except RuntimeError:
            if not quiet:
                raise
    return time.perf_counter() - t0


@contextmanager
def on_stream(stream):
    """Run the body on ``stream`` (None: on the current stream, untouched).
    The stream first waits for the work queued on its device's default
    stream, so that inputs made there are ready before the job reads
    them."""
    if stream is None:
        yield
        return
    torch = sys.modules["torch"]
    stream.wait_stream(torch.cuda.default_stream(stream.device))
    with torch.cuda.stream(stream):
        yield


class ThreadLocalStdout(io.TextIOBase):
    """Dispatches writes to a per-thread buffer, falling back to the real
    stdout. ``contextlib.redirect_stdout`` swaps the process-global
    ``sys.stdout``, so concurrent agents would capture each other's logs
    (the reference's subprocess worker does, ROADMAP C); this proxy keeps
    each worker's job log isolated."""

    def __init__(self, fallback):
        self.fallback = fallback
        self._local = threading.local()

    def push(self, buf) -> None:
        self._local.buf = buf

    def pop(self) -> None:
        self._local.buf = None

    def _target(self):
        return getattr(self._local, "buf", None) or self.fallback

    def write(self, s) -> int:
        return self._target().write(s)

    def flush(self) -> None:
        self._target().flush()

    def writable(self) -> bool:
        return True


_stdout_proxy_lock = threading.Lock()


@contextmanager
def capture_stdout(log_buf: io.StringIO):
    """Send what this thread prints to ``log_buf`` for the body's length;
    other threads' prints go where they went before."""
    with _stdout_proxy_lock:
        if not isinstance(sys.stdout, ThreadLocalStdout):
            sys.stdout = ThreadLocalStdout(sys.stdout)
        proxy = sys.stdout
    proxy.push(log_buf)
    try:
        yield
    finally:
        proxy.pop()
