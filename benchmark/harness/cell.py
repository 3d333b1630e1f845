"""One run of a cell: set-up, the measured window, the traced frames, and
the comparison with the plain reference once the window has closed.

The traffic file (``traffic/<mix>.json``) says what the frames are:

- ``renderer``: the renderer's module and class inside the package
  (``renderer.NrcRenderer``), the same on both sides; each frame is its
  ``step(state, camera, **arguments)``;
- ``camera``: the file of ``cameras/`` that gives each frame's camera;
- ``checkpoint`` (where the program starts from a trained cache, as a
  viewer loads one): the reference runs ``frames`` frames with the
  ``step`` arguments from the seed before the program starts, and the
  program's ``init_state(seed, nrc=...)`` takes the reference's cache;
  those seconds count for no metric;
- ``setup``: the set-up's frames in order, each ``{"frames": n, "step":
  {...}}``; the first frame builds and loads every kernel;
- ``window``: the ``step`` arguments of the window's frames;
- ``check_frames``: the window frame the reference works out again is
  drawn from the seed among the first this many;
- ``trace_frames``: how many window frames the traced run profiles (from
  the second on);
- ``control``: how ``control.py`` builds the control: ``overrides`` of the
  reference's configuration, or a ``fault`` of ``harness/faults.py``.

After the window the reference works out again (``run_checks``):

- ``start.*``: the set-up from the state the program started from (the
  seed, or the checkpoint), through its last training frame and at least
  its first frame: the first frame's image and, where the set-up trains,
  the first training frame's first three optimizer steps;
- ``setup.update``: where the set-up trains, each leaf's change of the
  parameters and of their average over the whole set-up;
- ``window.*``: one window frame drawn from the seed, from the program's
  state before it, with the key and the blend index worked out by the
  reference and, where the window does not train, the reference's own
  checkpoint: its image, and its loss where it trains.

Where the window trains, the window frame starts from the program's
cache: two runs of the same training a round-off apart part ways within
frames (an optimizer step moves an entry whose gradient is near zero by
about the learning rate, either way), so the training that led there is
held by ``start.*`` and ``setup.update``, each from the seed.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import sys
import time

import torch

from . import compare, registry, sides
from .probes import Probes
from .trace import breakdown, trace_events, union_ns
from .window import run_window

START_STEPS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Traced:
    """What the traced frames left for the per-layer metrics: the frames
    profiled with the device's activity alone (``device``, their wall
    time, the probes' spans, calls and counts) and the one frame after
    them profiled with the host's activity too (``labelled``: its device
    operations and the host spans, which name the idle gaps)."""

    frames: int
    wall_s: float
    device: list
    busy_s: float
    spans: dict
    calls: dict
    counts: dict
    base: object
    labelled: tuple = ([], [])

    def kernel_s(self, name: str) -> float:
        return sum(b - a for n, a, b in self.device if name in n) / 1e9

    def roofline(self, name: str):
        """100 x the summed bound of the kernel's recorded launches over
        its device time; None where the trace holds none of it."""
        from .peaks import bound_s

        mod = registry.roofline(name, self.base)
        t = self.kernel_s(mod.KERNEL)
        calls = self.calls.get(f"roofline.{name}", [])
        if t <= 0 or not calls:
            return None
        return 100.0 * sum(bound_s(**mod.cost(**c)) for c in calls) / t

    def breakdown(self) -> dict:
        """The device operations that took most time in the traced frames,
        and the labelled frame's longest idle gaps by host span."""
        def edges(ops):
            return (min((a for _, a, _ in ops), default=0),
                    max((b for _, _, b in ops), default=0))
        out = breakdown(self.device, [], *edges(self.device))
        dev, spans = self.labelled
        out["idle_gaps"] = breakdown(dev, spans, *edges(dev))["idle_gaps"]
        return out


def _probes(root, metric_mods, base, cuda: bool) -> Probes:
    spans, calls, counters = {}, {}, {}
    for m in metric_mods:
        spans.update(getattr(m, "SPANS", {}))
        calls.update(getattr(m, "CALLS", {}))
        counters.update(getattr(m, "COUNTERS", {}))
        for name in getattr(m, "ROOFLINES", []):
            r = registry.roofline(name, base)
            calls[f"roofline.{name}"] = (".".join(r.WRAPS), r.sizes)
    return Probes(root, spans, calls, counters, cuda)


class Tracer:
    """Profiles window frames [1, 1 + n) with the device's activity alone
    and the metrics' probes (recording the host's every operation would
    slow a frame of some 35,000 launches about twofold), then frame 1 + n
    with the host's activity too, for the names of its idle gaps."""

    def __init__(self, renderer, metric_mods, n: int, base, sync,
                 cuda: bool):
        self.n = n
        self.sync = sync
        self.probes = _probes(renderer, metric_mods, base, cuda)
        self.label_probes = Probes(renderer, self.probes.span_paths, {}, {},
                                   cuda)
        self.base = base
        self.cuda = cuda
        self.prof = None
        self.result = None

    def _profile(self, host: bool):
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        acts = (([ProfilerActivity.CUDA] if self.cuda else [])
                + ([ProfilerActivity.CPU] if host or not self.cuda else []))
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def on_frame(self, i: int) -> None:
        """Before window frame ``i``: profile frames 1 to n, then label
        frame n + 1."""
        if i == 1:
            self._profile(host=False)
            self.probes.install()
            self.t0 = time.perf_counter()
        elif i == 1 + self.n:
            self.stop(self.n)
            self._profile(host=True)
            self.label_probes.install()
        elif i == 2 + self.n:
            self.stop_labels()

    def stop(self, frames: int) -> None:
        """End the profile after ``frames`` profiled frames."""
        if self.prof is None or self.result is not None:
            return
        self.frames = frames
        self.sync()
        wall = time.perf_counter() - self.t0
        self.probes.remove()
        self.prof.__exit__(None, None, None)
        t_read = time.perf_counter()
        device, _ = trace_events(self.prof)
        log(f"trace: {self.frames} frames in {wall:.3f} s, {len(device)} "
            f"device operations, read in {time.perf_counter() - t_read:.1f}"
            " s")
        self.result = Traced(
            frames=self.frames, wall_s=wall, device=device,
            busy_s=union_ns(device) / 1e9, spans=self.probes.spans,
            calls=self.probes.calls, counts=self.probes.counts,
            base=self.base)
        self.prof = None

    def stop_labels(self) -> None:
        """End the labelled frame's profile, where it runs."""
        if self.prof is None or self.result is None:
            return
        self.sync()
        self.label_probes.remove()
        self.prof.__exit__(None, None, None)
        self.result.labelled = trace_events(self.prof)
        self.prof = None


def _record_steps(cache, sink: list):
    """Wrap the instance's ``train_step`` to keep each step's state."""
    had = "train_step" in vars(cache)
    inner = cache.train_step

    def run(*a, **kw):
        out = inner(*a, **kw)
        sink.append(out)
        return out

    def undo():
        if had:
            cache.train_step = inner
        else:
            del cache.train_step
    cache.train_step = run
    return undo


def _frames(phases: list) -> list:
    """The ``step`` arguments of each frame of ``phases``, in order."""
    return [ph.get("step", {}) for ph in phases for _ in range(ph["frames"])]


def _trains(kw: dict) -> bool:
    return bool(kw.get("train", False))


def _copy(obj, device):
    """A copy of a state (dataclasses, dicts, lists of tensors) on
    ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _copy(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copy(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _copy(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


@dataclasses.dataclass
class Setup:
    """What the set-up's frames produced that the comparison reads: the
    first frame's image; of the first training frame's first optimizer
    steps the losses, the first gradient's norm by leaf and the
    parameters' change by leaf after the last of them; the change of the
    parameters and of their average by leaf over the whole set-up."""

    first_image: object = None
    step_losses: list = None
    grad_norms: list = None
    change_norms: list = None
    setup_change: list = None


def _start_numbers(rec: Setup, params0, steps: list) -> None:
    steps = steps[:START_STEPS]
    rec.step_losses = [s.loss for s in steps]
    rec.grad_norms = compare.first_grad_norms(steps[0].opt_state)
    rec.change_norms = compare.change_norms(steps[-1].params, params0)


def _setup_change(nrc0, nrc1) -> list:
    return (compare.change_norms(nrc1.params, nrc0.params)
            + compare.change_norms(nrc1.ema_params, nrc0.ema_params))


def make_checkpoint(ref, traffic: dict, seed: int):
    """The reference's cache after the checkpoint's frames from the
    seed."""
    r = ref.renderer
    state = r.init_state(seed)
    for i, kw in enumerate(_frames([traffic["checkpoint"]])):
        state = r.step(state, ref.camera(i), **kw)
    return state.nrc


def _init_state(renderer, seed: int, ck):
    return renderer.init_state(seed) if ck is None else \
        renderer.init_state(seed, nrc=ck)


def run_setup(side, traffic: dict, seed: int, sync, ck=None):
    """The program's set-up frames from ``init_state(seed)``, or from the
    checkpoint ``ck`` (already in the program's classes)."""
    r = side.renderer
    state = _init_state(r, seed, ck)
    nrc0 = getattr(state, "nrc", None)
    rec = Setup()
    frames = _frames(traffic["setup"])
    first_train = next((i for i, kw in enumerate(frames) if _trains(kw)),
                       None)
    for i, kw in enumerate(frames):
        steps, undo, params0 = [], None, None
        if i == first_train:
            params0 = state.nrc.params
            undo = _record_steps(r.cache, steps)
        state = r.step(state, side.camera(i), **kw)
        sync()
        if undo:
            undo()
            _start_numbers(rec, params0, steps)
        if i == 0:
            rec.first_image = state.image
    if first_train is not None:
        rec.setup_change = _setup_change(nrc0, state.nrc)
    return state, rec


def _blend_weight(blend_index: int) -> float:
    import numpy as np
    return float(np.float32(1.0) / np.float32(blend_index))


def run_checks(ref, traffic: dict, seed: int, setup: Setup, snap, k: int,
               ck=None) -> dict:
    """The numbers of the cell's comparisons (name -> value).  ``snap``:
    the program's state before and after window frame ``k``; ``ck``: the
    reference's own checkpoint, where the traffic loads one."""
    out = {}
    rr = ref.renderer
    start = _init_state(rr, seed, ck)
    nrc0 = getattr(start, "nrc", None)
    frames = _frames(traffic["setup"])
    trained = [i for i, kw in enumerate(frames) if _trains(kw)]
    st, ref_rec = start, Setup()
    for i, kw in enumerate(frames[:max(trained, default=0) + 1]):
        rec = {}
        params0 = getattr(st, "nrc", None) and st.nrc.params
        st = rr.step(st, ref.camera(i), **kw, record=rec)
        if i == 0:
            out["start.image"] = compare.image_gap(
                setup.first_image, st.image, rec["out"], 1.0)
        if trained and i == trained[0]:
            _start_numbers(ref_rec, params0, rec["steps"])
            out.update(_start_training(setup, ref_rec))
    if trained:
        keep = compare.keep_leaves(ref_rec.grad_norms)
        out["setup.update"] = compare.leaf_gap(
            setup.setup_change, _setup_change(nrc0, st.nrc), keep + keep)
    del st

    before, after = snap
    n = len(frames) + k
    key = start.key
    for _ in range(n):
        key = ref.module.prng.split(key)[0]
    worked_out = {"key": key, "blend_index": start.blend_index + n}
    window_kw = traffic["window"]
    if ck is not None and not _trains(window_kw):
        worked_out["nrc"] = ck
    state = dataclasses.replace(sides.convert(before, ref.module),
                                **worked_out)
    rec = {}
    res = rr.step(state, ref.camera(n), **window_kw, record=rec)
    out["window.image"] = compare.image_gap(
        after.image, res.image, rec["out"], _blend_weight(state.blend_index))
    if _trains(window_kw):
        out["window.loss"] = compare.loss_gap([after.nrc.loss],
                                              [res.nrc.loss])
    return out


def _start_training(p: Setup, r: Setup) -> dict:
    """The first three optimizer steps of both sides: each step's loss,
    the first gradient's norm by leaf, the parameters' change after three
    steps by leaf."""
    keep = compare.keep_leaves(r.grad_norms)
    return {
        "start.loss": compare.loss_gap(p.step_losses, r.step_losses),
        "start.grad": compare.leaf_gap(p.grad_norms, r.grad_norms, keep),
        "start.update": compare.leaf_gap(p.change_norms, r.change_norms,
                                         keep),
    }


def run(cell: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, base=registry.HERE, root=registry.ROOT,
        program: str = "nrc_hpm_tpu_torch", overrides: dict | None = None,
        program_overrides: dict | None = None, fault=None) -> dict:
    """One run of ``cell``.  Returns the run's record: set-up seconds, the
    window, the peak device memory, the traced frames' metrics and the
    comparison's numbers.  ``program`` and ``program_overrides`` put
    another side in the program's place (the control); ``fault(side)``
    breaks the program's side after it is built; ``overrides`` shrink
    both sides (the tests')."""
    bench = registry.load_benchmark(root)
    w = registry.workload(bench, cell)
    cfg_file = registry.config(w["config"], base)
    traffic = registry.traffic(w["traffic"], base)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dens = sides.make_cloud(cfg_file)

    ck, ck_s = None, 0.0
    if "checkpoint" in traffic:
        t_ck = time.perf_counter()
        ref = sides.build("reference", cfg_file, traffic, dens, device,
                          overrides, base)
        ck = _copy(make_checkpoint(ref, traffic, seed), "cpu")
        del ref
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ck_s = time.perf_counter() - t_ck
        log(f"checkpoint: the reference's {traffic['checkpoint']['frames']}"
            f" frames from the seed in {ck_s:.1f} s (not set-up)")

    side = sides.build(program, cfg_file, traffic, dens, device,
                       {**(overrides or {}), **(program_overrides or {})},
                       base)
    if fault is not None:
        fault(side)
    loaded = None if ck is None else sides.convert(_copy(ck, device),
                                                   side.module)
    state, setup = run_setup(side, traffic, seed, sync, loaded)
    del loaded
    setup_s = time.perf_counter() - t_start - ck_s
    log(f"set-up {setup_s:.2f} s")

    tracer = None
    if trace:
        mods = [registry.metric(m, base)
                for m in registry.cell_metrics(bench, cell, "per_layer")]
        tracer = Tracer(side.renderer, mods, traffic["trace_frames"], base,
                        sync, cuda)
    k = random.Random(seed).randrange(traffic["check_frames"])
    r, cam = side.renderer, side.camera
    n_setup = len(_frames(traffic["setup"]))
    window_kw = traffic["window"]
    holder = {"state": state, "snap": None}
    host_ms = []

    def frame(i):
        before = holder["state"]
        t0 = time.perf_counter()
        holder["state"] = r.step(before, cam(n_setup + i), **window_kw)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        sync()
        if i == k:
            holder["snap"] = (before, holder["state"])

    gc0 = sum(g["collections"] for g in gc.get_stats())
    win = run_window(frame, seconds, min_frames=k + 1,
                     on_frame=tracer.on_frame if tracer else None)
    if tracer:
        tracer.stop(min(len(win.ends) - 1, tracer.n))
        tracer.stop_labels()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_gc = sum(g["collections"] for g in gc.get_stats()) - gc0
    ms = sorted(1e3 * f for f in win.frame_s) or [math.nan]
    log(f"window: {len(win.ends)} frames run, {win.completed} completed "
        f"in {seconds} s; ms min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} "
        f"max {ms[-1]:.1f}; {n_gc} garbage collections; device memory "
        f"reserved {torch.cuda.memory_reserved() if cuda else 0}")
    log("frame ms: " + " ".join(f"{1e3 * f:.0f}" for f in win.frame_s))
    log("host ms (until step returned): "
        + " ".join(f"{t:.0f}" for t in host_ms))
    snap = holder["snap"]
    del holder, state
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = sides.build("reference", cfg_file, traffic, dens, device,
                      overrides, base)
    numbers = run_checks(ref, traffic, seed, setup, snap, k,
                         None if ck is None else _copy(ck, device))
    log(f"reference and comparison {time.perf_counter() - t_ref:.1f} s")
    return dict(setup_s=setup_s, window=win, pixels=side.pixels,
                peak_bytes=peak, traced=tracer.result if tracer else None,
                numbers=numbers)


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number finite and within
    its limit; a number without a limit, or a limit without a number,
    fails."""
    rows = [(k, numbers.get(k, math.nan), limits.get(k, math.nan))
            for k in sorted(set(numbers) | set(limits))]
    ok = all(math.isfinite(v) and math.isfinite(lim) and v <= lim
             for _, v, lim in rows)
    return ok, rows
