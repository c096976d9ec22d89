"""Read a `torch.profiler` Chrome trace into what the per-layer metrics and
the breakdown need: the benchmark's spans on the host, the device's
operations, and the host's kernel launches, joined by correlation id.

The pattern is chip_smoke.py's `trace` at the commit that added this
benchmark (device time by kernel from the profiler, user annotations left
out, the host's `cudaLaunchKernel` calls counted), taken from the exported
Chrome trace instead of `key_averages()`, so that each device operation
keeps its start, its end and the launch that issued it.
"""

from __future__ import annotations

import bisect
import json

#: Prefix of every span the benchmark records (hooks.py, run.py).
SPAN = "fhebench:"
CALL = SPAN + "call"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


#: Characters of a device operation's name kept in the breakdown.
NAME_CHARS = 96


def _short(name: str) -> str:
    """A kernel's name without its argument list (a template's own
    parentheses kept, "(anonymous namespace)" and a copy's "(Pageable ->
    Device)" too), cut to NAME_CHARS."""
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if (ch == "(" and depth == 0 and i and name[i - 1] != " "
                and not name.startswith("(anonymous", i)):
            name = name[:i]
            break
    return name[:NAME_CHARS]


def _merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """One profiled window. Times are in seconds on the profiler's clock,
    which the host's and the device's events share."""

    def __init__(self, events: list):
        self.spans: dict[str, list[tuple[float, float]]] = {}
        self.device_ops: list[tuple[float, float, str, int | None]] = []
        launch_ts: dict[int, float] = {}
        self.launches: list[float] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            ts, dur = float(ev.get("ts", 0)) * 1e-6, float(ev.get("dur", 0)) * 1e-6
            corr = (ev.get("args") or {}).get("correlation")
            if cat == "user_annotation" and name.startswith(SPAN):
                self.spans.setdefault(name, []).append((ts, ts + dur))
            elif cat in _DEVICE_CATS:
                self.device_ops.append((ts, ts + dur, name, corr))
            elif cat in _LAUNCH_CATS and "LaunchKernel" in name:
                self.launches.append(ts)
                if corr is not None:
                    launch_ts[corr] = ts
            elif cat in _LAUNCH_CATS and corr is not None and "Memcpy" in name:
                launch_ts[corr] = ts
        self.launches.sort()
        self._launch_ts = launch_ts
        calls = self.spans.get(CALL, [])
        self.window = (min(s for s, _ in calls), max(e for _, e in calls)) if calls else None
        inside = []
        if self.window:
            w0, w1 = self.window
            inside = [(max(s, w0), min(e, w1)) for s, e, _, _ in self.device_ops
                      if e > w0 and s < w1]
        self.busy = _merge(inside)

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(e - s for s, e in self.busy)

    def span_count(self, name: str) -> int:
        return len(self.spans.get(SPAN + name, []))

    def span_seconds(self, name: str) -> float:
        """Host seconds inside the spans `name` (they do not nest in
        themselves)."""
        return sum(e - s for s, e in self.spans.get(SPAN + name, []))

    def _inside(self, name: str):
        """A test of whether a host time lies inside a span `name`."""
        spans = _merge(self.spans.get(SPAN + name, []))
        starts = [s for s, _ in spans]

        def test(t: float) -> bool:
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= spans[i][1]

        return test

    def launches_in(self, name: str) -> int:
        """Kernel launches the host made inside the spans `name`."""
        inside = self._inside(name)
        return sum(1 for t in self.launches if inside(t))

    def device_seconds_launched_in(self, name: str) -> float:
        """Device seconds of the operations whose launch lay inside the spans
        `name`."""
        inside = self._inside(name)
        total = 0.0
        for s, e, _, corr in self.device_ops:
            t = self._launch_ts.get(corr)
            if t is not None and inside(t):
                total += e - s
        return total

    def device_ops_by_name(self, top: int = 10) -> list:
        """[name, seconds] of the device operations in the window that took
        the most time, summed by name (a kernel's name without its argument
        list, at most NAME_CHARS characters)."""
        if not self.window:
            return []
        w0, w1 = self.window
        by: dict[str, float] = {}
        for s, e, name, _ in self.device_ops:
            if e > w0 and s < w1:
                key = _short(name)
                by[key] = by.get(key, 0.0) + min(e, w1) - max(s, w0)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps_by_span(self, top: int = 10) -> list:
        """[span, seconds]: the window's idle device time, each gap put to
        the innermost benchmark span the host was in when it began."""
        if not self.window:
            return []
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        spans = [(s, e, name[len(SPAN):]) for name, ivs in self.spans.items()
                 for s, e in ivs]
        by: dict[str, float] = {}
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            holding = [(s, name) for s, e, name in spans if s <= g0 < e]
            name = max(holding)[1] if holding else "outside"
            by[name] = by.get(name, 0.0) + g1 - g0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
