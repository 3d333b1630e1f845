"""The port's tracer (``nrc_hpm_tpu_torch/profiler.py``) on the CPU at
32x18 on an 8^3 volume.  Off, a frame records nothing, and a frame traced
under ``torch.profiler`` is bit for bit an untraced one.  On, each step
records one ``nrc.frame`` whose spans nest, the ``rng`` region counts a
nested entry once, each span's ``time.time_ns()`` stamps hold its
``record_function`` event in the profiler's trace, within 200 us, and a
frame counts one host sync at every operation that waits for the card."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nrc_hpm_tpu_torch import integrator, profiler
from nrc_hpm_tpu_torch.camera import Camera
from nrc_hpm_tpu_torch.config import AppConfig
from nrc_hpm_tpu_torch.models.nrc.cache import tree_leaves
from nrc_hpm_tpu_torch.renderer import McRenderer, NrcRenderer
from nrc_hpm_tpu_torch.utils import rng
from nrc_hpm_tpu_torch.volume import Volume

W, H = 32, 18
STAMP_NS = 200_000
STAGES = {"nrc.primary", "nrc.pack", "nrc.infer", "nrc.composite",
          "nrc.clear", "nrc.train_set", "nrc.train_frame"}


def _cfg() -> AppConfig:
    cfg = AppConfig()
    return dataclasses.replace(
        cfg, render_width=W, render_height=H, log2_train_batch_size=6,
        train_ray_length=4, mc_path_length=4,
        encoding=dataclasses.replace(cfg.encoding, log2_hashmap_size=12))


@pytest.fixture(scope="module")
def scene():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    r = NrcRenderer(_cfg(), Volume.from_dense(data, 0.6, 0.8, device="cpu"))
    cam = Camera.reference_camera(W / H, device="cpu")
    return r, cam, r.init_state(0)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _leaves(st):
    return tree_leaves([st.image, dataclasses.asdict(st.ring), st.key,
                        st.nrc.params, st.nrc.ema_params,
                        st.nrc.opt_state["mu"], st.nrc.opt_state["nu"],
                        st.nrc.loss])


def test_off_records_nothing_and_tracing_changes_no_bit(scene):
    r, cam, s0 = scene
    before = [id(f) for f in profiler.frames()]
    assert not profiler.enabled()
    plain = r.step(s0, cam)
    assert [id(f) for f in profiler.frames()] == before
    traced, _ = _traced(lambda: r.step(s0, cam))
    assert len(profiler.frames()[-1].spans) > 1
    assert all(torch.equal(a, b) for a, b in zip(_leaves(plain),
                                                _leaves(traced)))
    assert (plain.blend_index, plain.nrc.step) == (traced.blend_index,
                                                    traced.nrc.step)


def _check_nesting(f):
    ids = {s.id: s for s in f.spans}
    assert [s for s in f.spans if s.name == profiler.FRAME] == [f.root]
    for s in f.spans:
        if s is not f.root:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s
    assert sum(f.syncs.values()) == sum(s.name == profiler.SYNC
                                        for s in f.spans)
    return ids


def test_one_frame_a_step_and_its_spans_nest(scene):
    r, cam, s0 = scene
    mc = McRenderer(_cfg(), r.vol)

    def frames():
        s1 = r.step(s0, cam)
        r.step(s1, cam, train=False)
        mc.step(mc.init_state(0), cam)
    _traced(frames)
    online, frozen, mc_frame = profiler.frames()[-3:]
    assert online.root.end_ns <= frozen.root.start_ns
    assert frozen.root.end_ns <= mc_frame.root.start_ns
    for f, stages in ((online, STAGES),
                      (frozen, STAGES - {"nrc.train_set", "nrc.train_frame"}),
                      (mc_frame, set())):
        ids = _check_nesting(f)
        assert {s.name for s in f.spans
                if s.parent == f.root.id} - {profiler.SYNC} == stages | (
            {"nrc.bounce"} if f is mc_frame else set())
        for s in f.spans:
            if s.name == "nrc.bounce":
                stage = ids[s.parent].name
                assert (s.attrs["path"], stage) in {
                    ("primary", "nrc.primary"), ("train", "nrc.train_set"),
                    ("mc", profiler.FRAME)}
                assert s.attrs["lanes"] >= 0
            if s.name == "nrc.track":
                assert ids[s.parent].name == "nrc.bounce"
                assert s.attrs["kind"] in ("delta", "ratio")
                assert s.attrs["segments"] >= 0 and s.attrs["lanes"] > 0
        assert f.regions["rng"][1] > 0
    lanes = [s.attrs["lanes"] for s in sorted(online.spans,
                                              key=lambda s: s.start_ns)
             if s.name == "nrc.bounce" and s.attrs["path"] == "train"]
    assert lanes[0] == r.train_w * r.train_h and lanes == sorted(lanes)[::-1]


def test_rng_region_counts_a_nested_entry_once():
    state = torch.rand(64)
    active = state > 0.5

    def draws():
        with profiler.span(profiler.FRAME):
            rng.masked_uniform(state, active)     # rng.uniform inside
            rng.uniform(state)
            integrator._advance_dead(state, active, 3)
    _traced(draws)
    ns, calls = profiler.frames()[-1].regions["rng"]
    assert calls == 3 and ns > 0


def test_span_stamps_lie_within_their_profiler_events(scene):
    """Each span holds its ``record_function`` event (its stamps come just
    before entering and just after leaving it), which holds only where
    both share one clock; the stamps lie within 200 us of the event's
    (all but a twentieth of the spans: a host that deschedules the thread
    between a stamp and the event's own stretches that one span)."""
    r, cam, s0 = scene
    _traced(lambda: r.step(s0, cam))      # the profiler's first entries
    _, prof = _traced(lambda: r.step(s0, cam))
    f = profiler.frames()[-1]
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.is_user_annotation()), key=lambda e: e[1])
    spans = sorted(f.spans, key=lambda s: s.start_ns)
    assert [e[0] for e in events] == [s.name for s in spans]
    far = 0
    for (_, a, b), s in zip(events, spans):
        assert s.start_ns <= a <= b <= s.end_ns, (s, a, b)
        far += max(a - s.start_ns, s.end_ns - b) > STAMP_NS
    assert far <= len(spans) // 20


def test_a_frame_counts_a_sync_at_every_site(scene, monkeypatch):
    """The frame's syncs: one at each ``torch.nonzero``, and one at each
    copy of host memory to the card, made by ``new_ray_dir`` and by
    ``rng.init_state``; each counted here by a wrapper."""
    r, cam, s0 = scene
    calls = collections.Counter()

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(torch, "nonzero", counted("nonzero", torch.nonzero))
    monkeypatch.setattr(integrator, "new_ray_dir",
                        counted("new_ray_dir", integrator.new_ray_dir))
    monkeypatch.setattr(rng, "init_state",
                        counted("init_state", rng.init_state))
    _traced(lambda: r.step(s0, cam))
    syncs = profiler.frames()[-1].syncs
    copies = syncs["new_ray_dir"] + syncs["rng.init_state"]
    assert calls["nonzero"] > 0
    assert sum(syncs.values()) - copies == calls["nonzero"]
    assert syncs["new_ray_dir"] == calls["new_ray_dir"]
    assert syncs["rng.init_state"] == calls["init_state"] == 2
