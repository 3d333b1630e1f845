"""The traced run's probes, installed from the benchmark's own files around
the port's calls and removed after the traced frames; nothing is added
inside the program.

- a span wraps a method of the renderer instance (a dotted path such as
  ``cache.train_frame``): it names the call in the trace and times it by
  CUDA events recorded on the stream at its entry and its return, so it
  adds no synchronization (on the CPU, by the host clock);
- a call record wraps a method of the renderer instance or a function of
  one of the port's modules and keeps the sizes of each call's arguments;
- a counter is a ``.launches`` attribute of one of the port's functions,
  read before and after.
"""

from __future__ import annotations

import importlib
import time


def _resolve(root, path: str):
    """(object, attribute) of a dotted ``path``: below ``root`` (the
    renderer), or a module's function where the path names a module."""
    owner_path, attr = path.rsplit(".", 1) if "." in path else ("", path)
    if owner_path.startswith("nrc_hpm_tpu_torch"):
        return importlib.import_module(owner_path), attr
    owner = root
    for part in filter(None, owner_path.split(".")):
        owner = getattr(owner, part)
    return owner, attr


class _Wrapped:
    """``fn`` in the place of ``inner``: attributes read and written on it
    reach ``inner``, so a function that counts its own launches through
    its module's name (``f.launches += 1``) still counts them."""

    def __init__(self, inner, fn):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_fn", fn)

    def __call__(self, *a, **kw):
        return self._fn(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)


class Probes:
    """Spans, call records and counters over one bounded run of frames."""

    def __init__(self, root, spans: dict, calls: dict, counters: dict,
                 cuda: bool):
        self.root = root
        self.span_paths = spans          # name -> path
        self.call_paths = calls          # name -> (path, sizes fn)
        self.counter_paths = counters    # name -> path of a function
        self.cuda = cuda
        self._marks = {k: [] for k in spans}
        self.spans = {k: [] for k in spans}
        self.calls = {k: [] for k in calls}
        self.counts = {}
        self._undo = []
        self._start_counts = {}

    def _wrap(self, path: str, make):
        owner, attr = _resolve(self.root, path)
        inner = getattr(owner, attr)
        had = attr in vars(owner)
        setattr(owner, attr, _Wrapped(inner, make(inner)))
        self._undo.append((owner, attr, inner, had))

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def install(self) -> None:
        from torch.profiler import record_function

        for name, path in self.span_paths.items():
            def make(inner, name=name):
                def run(*a, **kw):
                    with record_function(name):
                        t0 = self._mark()
                        out = inner(*a, **kw)
                        self._marks[name].append((t0, self._mark()))
                    return out
                return run
            self._wrap(path, make)
        for name, (path, sizes) in self.call_paths.items():
            def make(inner, name=name, sizes=sizes):
                def run(*a, **kw):
                    self.calls[name].append(sizes(*a, **kw))
                    return inner(*a, **kw)
                return run
            self._wrap(path, make)
        self._start_counts = {k: self._counter(p)
                              for k, p in self.counter_paths.items()}

    def _counter(self, path: str) -> int:
        owner, attr = _resolve(self.root, path)
        return getattr(owner, attr).launches

    def remove(self) -> None:
        """Read the counters and spans (after the device has finished the
        traced frames) and take the probes out."""
        self.counts = {k: self._counter(p) - self._start_counts[k]
                       for k, p in self.counter_paths.items()}
        self.spans = {k: [a.elapsed_time(b) if self.cuda
                          else 1e3 * (b - a) for a, b in marks]
                      for k, marks in self._marks.items()}
        for owner, attr, inner, had in reversed(self._undo):
            if had:
                setattr(owner, attr, inner)
            else:
                delattr(owner, attr)
        self._undo = []
