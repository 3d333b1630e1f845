"""The port's tracer, and the stage profile of an NRC frame built on it.

Tracing is on exactly while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``).  Off, a site costs one
flag check and records nothing.  On:

- ``span(name, **attrs)`` records a named interval: its start and end by
  ``time.time_ns()``, the clock the profiler stamps its host and device
  events with (so spans and device operations compare directly), the id
  of its parent span and small attributes.  It also opens
  ``torch.profiler.record_function(name)``, so a profiler trace carries
  the program's spans beside the device's operations;
- ``region(name)`` decorates a function called very often (the RNG and
  draw glue): each call adds its host nanoseconds and one call to the
  frame's totals, with no span; a nested entry counts once, at the
  outermost;
- ``sync(site)`` is a context around each of the frame path's host syncs
  (``torch.nonzero``, ``bool`` of a device tensor, a copy from host
  memory to the card): it counts one sync under ``site`` and times the
  host's wait as a ``nrc.sync`` span.

A frame is the root span ``nrc.frame`` (``NrcRenderer.step``,
``McRenderer.step``); spans, syncs and regions outside a frame are not
kept.  ``frames()`` returns the last ``KEEP`` frames, held in memory.

The spans (``name``: where, attributes):
  nrc.frame        a renderer's ``step``
  nrc.clear        ring head/tail wrap (``ring_wrap``)
  nrc.primary      the primary pass (``NrcRenderer.primary``)
  nrc.pack         the 5-float queries (``pack_nrc_inputs``)
  nrc.infer        inference on the scattered pixels (``NrcRenderer.infer``)
  nrc.composite    composite and temporal blend
  nrc.train_set    train rays, their paths and the ring push
  nrc.train_frame  the frame's optimizer steps (``cache.train_frame``)
  nrc.bounce       one bounce of ``integrator.trace_path``: ``i``,
                   ``lanes`` (live at its start), ``path`` (primary,
                   train or mc)
  nrc.track        one ``pw`` tracker call: ``kind`` (delta, ratio),
                   ``lanes``, ``segments`` (segments run, K1 launches on
                   the kernel path)
  nrc.sync         one host sync: ``site``
and the region ``rng`` (``utils/rng.py``'s draws, the trackers' seeds and
indexed draws, the dead lanes' advance).

The stage profile (``profile_nrc_frame``) reports the JAX package's
stage taxonomy from the spans of real frames:
  clear        ring head/tail wrap                       nrc.clear
  gen_rays     primary short paths + NRC query export    nrc.primary
  prep_infer   5-float NrcInput pack                     nrc.pack
  filter       scattered-pixel compaction index          the sync at
                                                         infer_filter
  nn_infer     cache inference on the scattered pixels   nrc.infer less
                                                         filter
  prep_train   train rays, long paths, ring push, pack   nrc.train_set
  nn_train     the frame's optimizer steps               nrc.train_frame
  nn           nn_infer + nn_train
  render       composite + temporal blend                nrc.composite
``stage_sum`` adds the stages; ``total`` is the frame's time to the end
of its device work, and ``theoretical_fps`` 1000 / total.  A stage's time
is the host's time in its span: the frame is host-bound, and its syncs
keep the device close behind.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import os
import statistics
import time
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

FRAME = "nrc.frame"
SYNC = "nrc.sync"
KEEP = 256                  # frames held in memory


def enabled() -> bool:
    """Whether a ``torch.profiler`` session records, and so the tracer."""
    return _autograd_profiler._is_profiler_enabled


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start_ns: int = 0        # time.time_ns()
    end_ns: int = 0
    id: int = 0
    parent: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Frame:
    """One frame's records: its spans (the root, ``nrc.frame``, among
    them) in the order they closed, its host syncs by site, and each
    region's [host ns, calls]."""

    root: Span
    spans: list = dataclasses.field(default_factory=list)
    syncs: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    regions: dict = dataclasses.field(default_factory=dict)


class _Recorder:
    """The frames recorded so far, the frame being recorded, the open
    spans (innermost last) and the depth of each open region."""

    def __init__(self):
        self.frames = collections.deque(maxlen=KEEP)
        self.frame = None
        self.open = []
        self.ids = itertools.count(1)
        self.depth = collections.Counter()


_REC = _Recorder()


def frames() -> list:
    """The last ``KEEP`` frames recorded, oldest first."""
    return list(_REC.frames)


class _Off:
    """The span of a site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    """A recording span.  ``record_function`` opens after the start stamp
    and closes before the end stamp, so the span holds its profiler event
    (entering ``record_function`` costs the host more after the event's
    own stamp than before it; leaving costs it less)."""

    __slots__ = ("span", "rf")

    def __init__(self, name: str, attrs: dict):
        self.span = Span(name, attrs=attrs)

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.span.attrs.update(attrs)

    def __enter__(self):
        rec, s = _REC, self.span
        s.id = next(rec.ids)
        s.parent = rec.open[-1].id if rec.open else None
        if rec.frame is None and s.name == FRAME:
            rec.frame = Frame(root=s)
        rec.open.append(s)
        self.rf = torch.profiler.record_function(s.name)
        s.start_ns = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        s = self.span
        self.rf.__exit__(*exc)
        s.end_ns = time.time_ns()
        rec = _REC
        rec.open.pop()
        f = rec.frame
        if f is not None:
            f.spans.append(s)
            if s is f.root:
                rec.frames.append(f)
                rec.frame = None
        return False


def span(name: str, **attrs):
    """A context that records the span ``name`` while tracing is on; its
    ``set(**attrs)`` adds attributes from inside."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def region(name: str):
    """Decorator: while tracing is on, each outermost call of the region
    ``name`` adds its host nanoseconds and one call to the frame's
    totals."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            rec = _REC
            if not _autograd_profiler._is_profiler_enabled or \
                    rec.depth[name]:
                return fn(*a, **kw)
            rec.depth[name] += 1
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                ns = time.perf_counter_ns() - t0
                rec.depth[name] -= 1
                if rec.frame is not None:
                    tot = rec.frame.regions.setdefault(name, [0, 0])
                    tot[0] += ns
                    tot[1] += 1
        return run
    return wrap


class _Sync(_On):
    """A recording ``nrc.sync`` span that counts one sync at its site."""

    __slots__ = ()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if _REC.frame is not None:
            _REC.frame.syncs[self.span.attrs["site"]] += 1
        return False


def sync(site: str):
    """A context around one operation that waits for the device (on the
    card): while tracing is on, it counts one host sync at ``site`` and
    times the host's wait as a ``nrc.sync`` span."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Sync(SYNC, {"site": site})


@contextlib.contextmanager
def profile_trace(log_dir: str = os.path.join("output_torch", "trace")):
    """Wrap a region in torch.profiler (the host and, where there is one,
    the card) and write its Chrome trace to ``<log_dir>/trace.json``: the
    device's operations beside the program's spans."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# the stages that are a span of NrcRenderer.step, by the JAX package's key
STAGE_SPANS = {"clear": "nrc.clear", "gen_rays": "nrc.primary",
               "prep_infer": "nrc.pack", "nn_infer": "nrc.infer",
               "prep_train": "nrc.train_set", "nn_train": "nrc.train_frame",
               "render": "nrc.composite"}
FILTER_SITE = "infer_filter"    # the sync that is the stage "filter"
STAGES = ("clear", "gen_rays", "prep_infer", "filter", "nn_infer",
          "prep_train", "nn_train", "render")


def frame_stages(frame: Frame) -> Dict[str, float]:
    """{stage: ms} of one recorded NRC frame: each stage's host time in
    its span, less the time of the stages nested in it (the filter's
    sync inside ``nrc.infer``)."""
    stage_of = {v: k for k, v in STAGE_SPANS.items()}
    ids = {s.id: s for s in frame.spans}
    out = dict.fromkeys(STAGES, 0.0)
    for s in frame.spans:
        ms = (s.end_ns - s.start_ns) / 1e6
        if s.name in stage_of:
            out[stage_of[s.name]] += ms
        elif s.name == SYNC and s.attrs["site"] == FILTER_SITE:
            out["filter"] += ms
            parent = ids.get(s.parent)
            if parent is not None and parent.name in stage_of:
                out[stage_of[parent.name]] -= ms
    return out


def profile_nrc_frame(renderer, state, camera, reps: int = 3,
                      trace_dir: str | None = None) -> Dict[str, float]:
    """Profile ``reps`` real training frames from ``state`` (after one
    warm-up frame) by the spans of their stages.  Returns {stage: median
    ms} plus 'total' (the median frame, to the end of its device work),
    'theoretical_fps' = 1000/total and 'stage_sum'.  Every frame builds
    new tensors, so the caller's state is read and never written.  Where
    no ``torch.profiler`` session records, the frames run under one of
    the device's activity alone (the host's on the CPU).  With
    ``trace_dir``, one more frame runs under ``profile_trace(trace_dir)``
    for its Chrome trace."""
    cuda = torch.device(renderer.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    renderer.step(state, camera, train=True)
    sync()
    totals, t_start = [], time.time_ns()
    with contextlib.ExitStack() as stack:
        if not enabled():
            from torch.profiler import ProfilerActivity, profile
            stack.enter_context(profile(activities=[
                ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]))
        for _ in range(reps):
            t0 = time.perf_counter()
            renderer.step(state, camera, train=True)
            sync()
            totals.append(1e3 * (time.perf_counter() - t0))
    per = [frame_stages(f) for f in frames() if f.root.start_ns >= t_start]
    if len(per) != reps:
        raise RuntimeError(f"{reps} steps recorded {len(per)} frames")
    if trace_dir is not None:
        with profile_trace(trace_dir):
            renderer.step(state, camera, train=True)
            sync()
    out = {k: statistics.median(p[k] for p in per) for k in STAGES}
    out["nn"] = out["nn_infer"] + out["nn_train"]
    out["total"] = statistics.median(totals)
    out["theoretical_fps"] = 1000.0 / max(out["total"], 1e-9)
    out["stage_sum"] = sum(out[k] for k in STAGES)
    return out


def format_stage_report(stages: Dict[str, float]) -> str:
    """Human-readable per-stage table (the reference's frame panel)."""
    order = ["clear", "gen_rays", "prep_infer", "filter", "prep_train",
             "nn_infer", "nn_train", "nn", "render", "stage_sum", "total"]
    lines = ["frame stage breakdown (ms):"]
    for k in order:
        if k in stages:
            lines.append(f"  {k:<12s} {stages[k]:9.2f}")
    if "theoretical_fps" in stages:
        lines.append(f"  theoretical FPS: {stages['theoretical_fps']:.2f}")
    return "\n".join(lines)
