"""The traced run's profile: ``torch.profiler`` over the last ``seconds``
of the measured window, reduced once to what the per-layer readers need.

The profiler slows the host, so it runs at the window's end: the card is
drained first and the host clock read (``t0``), and readers that take a
rate or a latency from the run's own records take it from the window's
part before ``t0``. Recording every operator slows a host that launches
thousands of kernels a step, so the first half of the span records the
card's activity alone:

- ``intervals``: every device activity (kernels, copies, fills) as
  (name, start s, end s), first half;
- ``busy_s``: the length of their union; ``window_s``: the first half's
  span by the host's clock;
- ``ops``: the device time of the kernels each operator launched, per
  operator name and input shapes, second half, from the profiler's links
  between a launch and the operator around it;
- ``breakdown``: the device operations that took most time (first half),
  and the longest idle gaps, each named by the host operation that was
  running when it began (second half).
"""
from __future__ import annotations

import bisect
import collections
import re
import time

import torch

TOP = 10
RUNTIME = re.compile(r"^cu[A-Z]|^cuda[A-Z]")  # cudaLaunchKernel, cuLaunchKernel, ...


class Tracer:
    """Profiles the last ``seconds`` of the window in two halves (``arm``,
    then ``poll()`` from the window's loop, until ``stop()``): first the
    card's activity alone, which costs the host little, for the busy and
    idle time and the device operations; then every operator with its
    shapes as well, for the kernels' rooflines and the host operations that
    the idle gaps fall in."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled, self.seconds = enabled, seconds
        self.device_prof = self.full_prof = None
        self.start_at = self.mid_at = self.t0 = self.window_s = None
        self.summary = None

    def arm(self, window_start: float, window_end: float) -> None:
        self.start_at = max(window_start, window_end - self.seconds)
        self.mid_at = (self.start_at + window_end) / 2

    @staticmethod
    def _profile(operators: bool):
        """The card's activity, with every operator and its shapes where
        ``operators``. On the card the profiler records what the thread
        that starts it launches, and little else: a driver polls and stops
        the tracer from the thread that launches the timed work."""
        acts = [torch.profiler.ProfilerActivity.CPU] if operators else []
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts or [torch.profiler.ProfilerActivity.CPU],
                                      record_shapes=operators)

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def poll(self) -> None:
        if not self.enabled or self.start_at is None or self.window_s is not None:
            return
        now = time.perf_counter()
        if self.device_prof is None and now >= self.start_at:
            self._sync()
            self.device_prof = self._profile(operators=False)
            self.t0 = time.perf_counter()
            self.device_prof.start()
        elif self.full_prof is None and self.device_prof is not None and now >= self.mid_at:
            self._sync()
            self.window_s = time.perf_counter() - self.t0
            self.device_prof.stop()
            self.full_prof = self._profile(operators=True)
            self.full_prof.start()

    def stop(self) -> None:
        """Called when the window closes; later calls do nothing."""
        if self.device_prof is None or self.start_at is None:
            return
        self._sync()
        if self.full_prof is None:  # the window closed before the second half
            self.window_s = time.perf_counter() - self.t0
            self.device_prof.stop()
        else:
            self.full_prof.stop()
        self.start_at = None

    def summarize(self):
        if self.device_prof is not None and self.summary is None:
            self.summary = Summary(self.device_prof, self.full_prof, self.window_s, self.t0)
            self.device_prof = self.full_prof = None
        return self.summary


def _union(spans: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Length of the union of (start, end) spans and the gaps between them."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(spans):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


class Summary:
    def __init__(self, device_prof, full_prof, window_s: float, t0: float):
        self.window_s, self.t0 = window_s, t0
        device = [e for e in device_prof.profiler.kineto_results.events()
                  if e.device_type() != torch.autograd.DeviceType.CPU]
        self.intervals = [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9) for e in device
                          if e.duration_ns() > 0]
        self.busy_s, _ = _union([(s, t) for _, s, t in self.intervals])
        by_op = collections.Counter()
        for name, s, t in self.intervals:
            by_op[name] += t - s
        self.device_ops = [[k, v] for k, v in by_op.most_common(TOP)]
        # operator name -> list of (input shapes, dtypes, device seconds)
        self.ops = collections.defaultdict(list)
        self.idle_gaps = []
        if full_prof is None:
            return
        cpu_ops, device, host = {}, [], []
        for e in full_prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.is_async():
                    continue
                # operators only: CUDA runtime and driver calls number their
                # correlations apart, and a launch links to its operator
                if not RUNTIME.match(e.name()):
                    cpu_ops.setdefault(e.correlation_id(), (e.name(), e.shapes(), e.dtypes()))
                host.append((e.start_ns() * 1e-9, e.end_ns() * 1e-9, e.name()))
            elif e.duration_ns() > 0:
                device.append(e)
        for e in device:
            op = cpu_ops.get(e.linked_correlation_id())
            if op is not None:
                self.ops[op[0]].append((op[1], op[2], e.duration_ns() * 1e-9))
        _, gaps = _union([(e.start_ns() * 1e-9, e.end_ns() * 1e-9) for e in device])
        self.idle_gaps = self._name_gaps(gaps, host)

    @staticmethod
    def _name_gaps(gaps, host) -> list:
        """The longest gaps, summed by the innermost host operation running
        at each gap's start."""
        host.sort()
        starts = [h[0] for h in host]
        named = collections.Counter()
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:1000]:
            i = bisect.bisect_right(starts, g0)
            best = None
            for s, e, name in reversed(host[max(0, i - 200):i]):
                if e >= g0 and (best is None or s > best[0]):
                    best = (s, name)
            named[best[1] if best else "(host idle)"] += g1 - g0
        return [[k, v] for k, v in named.most_common(TOP)]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}
