"""Communication/compute overlap checker of the parallel layer.

Twin of ``mfa_tpu/utils/overlap.py``. There the check proves from the
jaxpr that every ``ppermute`` result inside a scan body flows only into
the loop carry, never into a compute of the same iteration, so XLA may
run the transfer under the step's compute. The port's loops are Python:
the ring's (``parallel/ring_attention.py``, forward and backward) and the
pipeline's (``parallel/pipeline.py``) call :func:`note` as they issue a
transfer, finish a step's compute and wait for a transfer, and
:func:`check_overlap` runs a function while recording those events.

A transfer is in order when it is waited for only after the compute of
the step that issued it: the ring issues each rotation before its step's
compute and waits after it (the chunk is read by the next step); the
pipeline issues the hop of step t's output right after step t's compute
and waits at step t + 1, which reads it. A wait before the issuing
step's compute (a result that same step could read), or a transfer never
waited for, is a violation.

Recording costs one list append an event while a check runs and one
truth test otherwise. XLA's flags that make the TPU run the transfers
asynchronously (``mfa_tpu.parallel.multihost.ICI_OVERLAP_XLA_FLAGS``)
have no counterpart: NCCL runs point-to-point transfers on its own stream
as soon as they are posted.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field


@dataclass
class OverlapReport:
    """Per-loop accounting of the transfers' waits (``mfa_tpu``'s fields:
    ``scans_seen`` counts the loops run, ``permutes_seen`` the transfers
    issued)."""

    scans_seen: int = 0
    permutes_seen: int = 0
    violations: list = field(default_factory=list)   # (loop, message)
    details: list = field(default_factory=list)      # human-readable lines

    @property
    def ok(self) -> bool:
        return self.permutes_seen > 0 and not self.violations


# The event lists of the checks running in this process (innermost last).
_RECORDING: list[list] = []


def note(event: str, loop: str, step: int, transfer=None) -> None:
    """Record ``event`` ("issue", "compute" or "consume") of ``loop``'s
    step ``step`` while a check runs; "issue" and "consume" name their
    transfer object (None: no transfer, nothing recorded)."""
    if _RECORDING and (event == "compute" or transfer is not None):
        # The event keeps its transfer alive, so ids stay unique.
        _RECORDING[-1].append((event, loop, step, transfer))


@contextlib.contextmanager
def recording():
    """Collect the events of the enclosed block into the yielded list."""
    events: list = []
    with contextlib.ExitStack() as stack:
        _RECORDING.append(events)
        stack.callback(_RECORDING.remove, events)
        yield events


def analyse(events) -> OverlapReport:
    """The report of a recorded event list. A loop's steps count up from
    0 each time it runs."""
    report = OverlapReport()
    runs: list = []
    open_runs: dict = {}
    for event, loop, step, transfer in events:
        tid = id(transfer)
        run = open_runs.get(loop)
        if run is None or step < run["step"]:
            run = {"loop": loop, "computed": set(), "issued": {},
                   "consumed": set()}
            open_runs[loop] = run
            runs.append(run)
        run["step"] = step
        if event == "compute":
            run["computed"].add(step)
        elif event == "issue":
            run["issued"][tid] = (step, step in run["computed"])
        else:
            issue_step, _ = run["issued"].get(tid, (None, None))
            if issue_step is None:
                report.violations.append((loop, f"step {step} waits for a "
                                          "transfer it never issued"))
            elif issue_step not in run["computed"]:
                report.violations.append(
                    (loop, f"the transfer of step {issue_step} is waited "
                     f"for before that step's compute (at step {step})"))
            run["consumed"].add(tid)
    report.scans_seen = len(runs)
    for run in runs:
        report.permutes_seen += len(run["issued"])
        for tid, (step, after) in run["issued"].items():
            if tid not in run["consumed"]:
                report.violations.append(
                    (run["loop"], f"the transfer of step {step} is never "
                     "waited for"))
            report.details.append(
                f"{run['loop']}: step {step} transfer issued "
                f"{'after' if after else 'before'} its compute, waited for "
                f"{'after it' if tid in run['consumed'] else 'never'}")
    return report


def check_overlap(fn, *args, **kwargs) -> OverlapReport:
    """Run ``fn(*args, **kwargs)`` while recording and report whether
    every transfer of every ring and pipeline loop it ran is waited for
    only after its step's compute (see the module docstring);
    ``report.ok`` needs at least one transfer and no violation."""
    with recording() as events:
        fn(*args, **kwargs)
    return analyse(events)
