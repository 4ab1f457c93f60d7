"""Device time of the kernels on the card, from ``torch.profiler``.

One home for how the port times a kernel: ``chip_smoke.py``'s kernel table,
``tools/attention_ab.py`` and the autotuner's measure on the card
(``core/provision/autotune.py``) all call ``flushed_ms``. A kernel's time is
the profiler's device duration of its records, each call after an L2 flush,
so the host's time to enqueue a short kernel is not counted; windows whose
records the profiler dropped are refused.
"""
from __future__ import annotations

# the spin kernels at both ends of every profiled window (see profiled),
# and the calls profiled to count a function's kernels (kernel_count)
GUARD_CYCLES, GUARD_KERNEL = 20_000_000, "spin_kernel"
REF_CALLS = 5


def l2_flush_buffer(device):
    """A 256 MB int32 tensor on ``device``, larger than the H100's 50 MB
    L2 cache, for ``flushed_ms``'s flush."""
    import torch
    return torch.zeros(64 * 2**20, dtype=torch.int32, device=device)


def kernel_rows(prof, calls: int) -> list:
    """(device us, launches, name) per call of each CUDA kernel in a
    profile, largest first. CPU-op rows are left out: their device time is
    their child kernels', which have rows of their own; so are the device
    spans of record_function annotations, which cover kernels that have
    rows of their own."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total / calls, e.count / calls, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    return sorted(rows, reverse=True)


def profiled(fn, iters: int = 1) -> list:
    """kernel_rows, in totals, of iters calls of fn, between two spin
    kernels of about 10 ms each (``torch.cuda._sleep``), which are left out
    of the rows. On some cards the profiler dropped the first or the last
    kernel records of a window (a whole one-call window, or one flush of a
    timed one); the spins take the window's edges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(GUARD_CYCLES)
        for _ in range(iters):
            fn()
        torch.cuda._sleep(GUARD_CYCLES)
        torch.cuda.synchronize()
    return [row for row in kernel_rows(prof, 1) if GUARD_KERNEL not in row[2]]


def launches_of(rows, calls: int) -> dict:
    """{kernel name: launches per call} from the kernel_rows totals of
    ``calls`` calls. The profiler may have dropped one record of a kernel;
    a kernel whose records are not whole launches per call, short of at
    most one, raises, so a kernel that ran on only some of the calls is
    never rounded away."""
    out = {}
    for _, n, name in rows:
        n = round(n)
        per = -(-n // calls)
        if n < per * calls - 1:
            raise AssertionError(f"{name} ran {n} times in {calls} calls")
        out[name] = per
    return out


def kernel_count(fn) -> int:
    """CUDA kernels that one call of fn runs, from the profiler over
    REF_CALLS calls."""
    return sum(launches_of(profiled(fn, REF_CALLS), REF_CALLS).values())


def flushed_ms(fn, iters: int, flush, per_call: int | None = None) -> float:
    """Mean device time (ms) of fn's kernels per call, each call after
    flushing the L2 cache with ``flush.bitwise_xor_(1)`` on a tensor larger
    than the L2 (the serving path finds its inputs cold). Kernel durations
    come from the profiler, so the host's time to enqueue a short kernel is
    not counted; the flush's kernels, named by profiling the flush alone,
    are left out, and fn must run none of them. With ``per_call``, one call
    of fn must run exactly that many kernels. A window counts only if it
    holds exactly iters flushes and iters times fn's kernels per call (the
    profiler drops records now and then); the time is the median of three
    windows that count (one window in some tens read 36% slow), out of at
    most six, or of those that count if fewer do; none raises."""
    def flush_l2():
        flush.bitwise_xor_(1)

    fn()                                                        # warm-up
    launches = launches_of(profiled(fn, REF_CALLS), REF_CALLS)
    if per_call is not None and sum(launches.values()) != per_call:
        raise AssertionError(f"one call runs {sum(launches.values())} CUDA "
                             f"kernels, not {per_call}")
    for _ in range(3):
        flush_names = {name for _, _, name in profiled(flush_l2)}
        if flush_names:
            break
    if flush_names & set(launches):
        raise AssertionError("a timed function runs the L2 flush's kernel, "
                             "so its time cannot be told apart")
    times = []
    for _ in range(6):
        rows = profiled(lambda: (flush_l2(), fn()), iters)
        flushes = sum(n for _, n, name in rows if name in flush_names)
        kernels = [(us, n) for us, n, name in rows if name not in flush_names]
        if flush_names and flushes == iters * len(flush_names) and \
                sum(n for _, n in kernels) == iters * sum(launches.values()):
            times.append(sum(us for us, _ in kernels) / iters / 1e3)
            if len(times) == 3:
                break
    if not times:
        raise AssertionError("the profiler's timed windows lost kernel "
                             "records six times")
    return sorted(times)[len(times) // 2]
