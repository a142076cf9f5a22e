"""Call-count task-scheduling micro-framework (host side).

Capability parity with the reference's frame-granular task wrappers
(``DepthRenderer/utils.py:217-342``): delay a side effect by N frames, run it once,
or run it every Nth frame — used by the CLIs to sequence writers and shutdown around
the frame loop. In the batched device pipeline these gates are usually pre-computed as
frame index schedules (see ``render.py``), but the imperative API is kept for parity
and for the streaming host loop.
"""

from __future__ import annotations


class Task:
    """Encapsulates a callable (reference: ``utils.py:217-242``)."""

    def __init__(self, task):
        self.task = task
        self.call_count = 0

    def __call__(self, *args, **kwargs):
        return self.task(*args, **kwargs)

    def reset(self):
        """Clear the state of the task."""
        self.call_count = 0


class DelayedTask(Task):
    """Runs the task only after the first ``delay`` calls (reference: ``utils.py:245-271``)."""

    def __init__(self, task, delay=0):
        super().__init__(task)
        self.delay = delay

    def __call__(self, *args, **kwargs):
        self.call_count += 1
        if self.call_count > self.delay:
            return super().__call__(*args, **kwargs)


class OneTimeTask(Task):
    """Runs the task exactly once until reset (reference: ``utils.py:274-303``)."""

    def __init__(self, task):
        super().__init__(task)
        self.is_done = False

    def __call__(self, *args, **kwargs):
        self.call_count += 1
        if not self.is_done:
            self.is_done = True
            return super().__call__(*args, **kwargs)

    def reset(self):
        super().reset()
        self.is_done = False


class RecurringTask(Task):
    """Runs the task every ``frequency``-th call (reference: ``utils.py:306-342``)."""

    def __init__(self, task, frequency=1):
        super().__init__(task)
        assert frequency > 0, f"RecurringTask needs a frequency >= 1 (got {frequency})."
        self.frequency = frequency

    def __call__(self, *args, **kwargs):
        result = None
        if self.call_count % self.frequency == 0:
            result = super().__call__(*args, **kwargs)
        self.call_count += 1
        return result
