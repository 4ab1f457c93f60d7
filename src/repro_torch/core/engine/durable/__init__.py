"""Durable control plane: journaled engine state, crash-recoverable
restart, and the process-boundary runner (ACAI's Redis-backed engine,
reproduced as a pluggable StateStore + write-ahead journal).

A copy of ``repro/core/engine/durable/__init__.py``, with its imports in
``repro_torch.core``, and one change: ``SubprocessRunner`` is imported on
first use. The runner imports the launcher, and the launcher imports torch;
the job worker (``durable.worker``) imports this package, and loads torch
only when a job of its own does."""
from repro_torch.core.engine.durable.codec import (decode_job, decode_spec,
                                                   decode_transfer_costs,
                                                   encode_job, encode_spec,
                                                   encode_transfer_costs)
from repro_torch.core.engine.durable.journal import (Journal,
                                                     attach_terminal_recorder)
from repro_torch.core.engine.durable.recovery import (RecoveryReport, recover,
                                                      snapshot_state)
from repro_torch.core.engine.durable.store import (FileStore, MemoryStore,
                                                   StateStore)


def __getattr__(name):
    if name == "SubprocessRunner":
        from repro_torch.core.engine.durable.runner import SubprocessRunner
        return SubprocessRunner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
