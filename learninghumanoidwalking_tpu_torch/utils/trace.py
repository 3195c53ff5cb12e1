"""Named spans of the trainer's host work, recorded while a torch profiler runs.

``with span("env.step"): ...`` marks a stretch of host work. With no torch
profiler running, a span costs one check of the profiler's state: it enters
no ``torch.profiler.record_function`` and records nothing. While one runs
(``run_experiment train --profile-dir``, a benchmark window traced with
``--trace 1``), a span enters ``record_function(name)``, so Chrome traces
show it, and appends a ``Span`` to the recorder's list, timed with
``time.perf_counter_ns``. A recording starts, with an empty list, at the
first span that finds a profiler running, and ends at ``stop()`` (PPO.train
calls it when it returns or raises) or at the first span that finds the
profiler stopped; its list stays readable (``recorded()``) until the next
recording starts.

While recording on a process that has initialized CUDA, every blocking
host-device synchronization is counted and charged to the innermost open
span: ``torch.cuda.set_sync_debug_mode("warn")`` makes each one (``float()``
and ``.item()``, ``.tolist()``, a pageable ``torch.as_tensor(numpy,
device=cuda)``, a boolean-mask index, ...) raise a warning, which is
counted and never shown, until the recording ends.

The spans and what reads them (port_bench/metrics, rl/trace.py):

- ``ppo.iteration``, ``ppo.sample``, ``ppo.optimize``, ``ppo.eval``: rl/ppo.py
  ``PPO.train``'s parts of an iteration;
- ``ppo.grad_step``: one gradient step of both nets (``PPO._minibatch_step``);
- ``ppo.adam``: one ``Adam.step`` (two per gradient step);
- ``env.step``, ``env.reset``: envs/humanoid.py ``step_batch``, ``reset_batch``;
- ``physics.launch``: ops/substep_kernel.py ``pd_substeps_kernel``, the whole
  call, on the card and on the CPU;
- ``host.read``: each of the trainer's deliberate reads of device values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings

import torch

SPANS = ("ppo.iteration", "ppo.sample", "ppo.optimize", "ppo.eval", "ppo.grad_step", "ppo.adam",
         "env.step", "env.reset", "physics.launch", "host.read")
# spans kept per recording; later ones are counted in ``Recorder.dropped``
MAX_SPANS = 1 << 20
# the warning torch raises for a synchronizing CUDA operation in "warn" mode,
# and the one it raises once when the mode is set
SYNC_WARNING = "called a synchronizing CUDA operation"
MODE_WARNING = "Synchronization debug mode is a prototype feature"

_profiler_enabled = torch.autograd._profiler_enabled


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int | None  # None while open
    parent: int | None  # index of the enclosing span in the list; None at the top
    syncs: int = 0  # blocking synchronizations while this was the innermost open span


class Recorder:
    """The spans of one recording, the stack of open ones and the sync count."""

    def __init__(self):
        self.spans: list[Span] = []
        self.stack: list[int] = []  # indices of the open spans, innermost last (-1: not kept)
        self.on = False
        self.recordings = 0  # recordings started; a span exits into its own one only
        self.dropped = 0
        self.syncs_outside = 0  # counted syncs with no span open
        self._warnings = None  # the catch_warnings context while syncs are counted
        self._sync_mode = 0

    def start(self) -> None:
        self.spans, self.stack = [], []
        self.on, self.dropped, self.syncs_outside = True, 0, 0
        self.recordings += 1
        self._begin_sync_count()

    def stop(self) -> None:
        self.on = False
        self._end_sync_count()

    def _begin_sync_count(self) -> None:
        """Count syncs from now on, where this process has initialized CUDA."""
        if self._warnings is not None or not torch.cuda.is_initialized():
            return
        ctx = warnings.catch_warnings()
        ctx.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.filterwarnings("ignore", message=MODE_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                self._charge_sync()
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        self._warnings = ctx
        self._sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def _end_sync_count(self) -> None:
        if self._warnings is None:
            return
        torch.cuda.set_sync_debug_mode(self._sync_mode)
        self._warnings.__exit__(None, None, None)
        self._warnings = None

    def _charge_sync(self) -> None:
        if self.stack and self.stack[-1] >= 0:
            self.spans[self.stack[-1]].syncs += 1
        else:
            self.syncs_outside += 1


RECORDER = Recorder()


class _Open:
    """A span being recorded: record_function plus the recorder's entry."""

    __slots__ = ("name", "index", "recording", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = RECORDER
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.recording = rec.recordings
        if len(rec.spans) < MAX_SPANS:
            self.index = len(rec.spans)
            rec.spans.append(Span(self.name, time.perf_counter_ns(), None, rec.stack[-1] if rec.stack else None))
        else:
            self.index = -1
            rec.dropped += 1
        rec.stack.append(self.index)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = RECORDER
        if rec.recordings == self.recording:
            if self.index >= 0:
                rec.spans[self.index].end_ns = end
            if rec.stack and rec.stack[-1] == self.index:
                rec.stack.pop()
        self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over the host work named ``name`` (see the module's
    docstring); with no profiler running, one state check and nothing else."""
    if not _profiler_enabled():
        if RECORDER.on:
            RECORDER.stop()
        return _OFF
    if not RECORDER.on:
        RECORDER.start()
    return _Open(name)


def stop() -> None:
    """End the recording, if one runs: the next span that finds a profiler
    running starts a new one."""
    RECORDER.stop()


def recorded() -> list[Span]:
    """The spans of the last recording, in the order they started."""
    return RECORDER.spans
