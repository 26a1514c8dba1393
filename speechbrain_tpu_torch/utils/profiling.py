"""Profiling over ``torch.profiler`` (port of
``speechbrain_tpu/utils/profiling.py``): a tracer scheduled by steps
(wait, warm-up, active, as the reference's schedule) that writes a Chrome
trace (``chrome://tracing``, Perfetto) into ``logdir``; the Brain's
``profile_training`` option drives it over the batches ``profile_warmup +
1`` to ``profile_warmup + profile_steps`` of each train stage.
"""

import contextlib
import itertools
import logging
import os

import torch

logger = logging.getLogger(__name__)

_serial = itertools.count()  # traces written by this process


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Profiler:
    """Call :meth:`step` before each step: tracing starts before step
    ``wait + warmup + 1`` and stops before step ``wait + warmup + active
    + 1`` (or at :meth:`stop`), writing ``trace_<pid>_<n>.json`` into
    ``logdir`` (``n`` counts the traces of the process)."""

    def __init__(self, logdir="profiler_logs", wait=2, warmup=2, active=4):
        self.logdir = logdir
        self.wait = wait
        self.warmup = warmup
        self.active = active
        self.step_num = 0
        self.traces = []  # paths of the traces written
        self._prof = None

    def step(self):
        start_at = self.wait + self.warmup
        if self.step_num == start_at and self._prof is None:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
            logger.info("Profiler trace started -> %s", self.logdir)
        elif self.step_num == start_at + self.active:
            self.stop()
        self.step_num += 1

    def stop(self):
        """Stop tracing, if it runs, and write the trace."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir,
                            f"trace_{os.getpid()}_{next(_serial)}.json")
        prof.export_chrome_trace(path)
        self.traces.append(path)
        logger.info("Profiler trace saved -> %s", path)

    @property
    def done(self):
        return self.step_num > self.wait + self.warmup + self.active


def prepare_profiler(profile_warmup=5, profile_steps=10,
                     logdir="profiler_logs"):
    """A :class:`Profiler` over steps ``profile_warmup + 1`` to
    ``profile_warmup + profile_steps``."""
    return Profiler(logdir=logdir, wait=0, warmup=profile_warmup,
                    active=profile_steps)


@contextlib.contextmanager
def trace(logdir="profiler_logs"):
    """Trace a whole block into ``logdir/trace.json``:
    ``with trace(): step()``."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
