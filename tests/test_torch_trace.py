"""The port's program spans (``ssdn_tpu_torch/utils/debug.py``: ``span``,
``spans``, ``totals``, ``reset``) on the CPU: off without a profiler
session, in the profiler's timeline and on its clock with one, on worker
threads, one list per session; the spans the Trainer, the training step,
the Prefetcher's workers, ``denoise_image`` and ``evaluate_dataset`` make;
and results bit-equal with tracing on and off."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style
from ssdn_tpu_torch.data import open_dataset
from ssdn_tpu_torch.infer import evaluate_dataset
from ssdn_tpu_torch.infer import full as tfull
from ssdn_tpu_torch.parallel import Group
from ssdn_tpu_torch.train.loop import Trainer
from ssdn_tpu_torch.train.step import init_state, make_train_step
from ssdn_tpu_torch.utils import debug

TINY = dict(enc_features=8, dec_features=16, nin_a_features=32,
            nin_b_features=16, compute_dtype="float32")
STEPS = 4


def cfg(**kw):
    kw = {"iterations": STEPS, "eval_interval": 10_000, "guard_check": 2,
          **kw}
    return TrainConfig(noise=parse_noise_style("gauss25"),
                       model=ModelConfig(in_channels=3, **TINY),
                       patch_size=32, batch_size=2, snapshot_interval=10_000,
                       seed=3, **kw)


def profiled():
    """A profiler session whose spans start from an empty list."""
    debug.reset()
    return profile(activities=[ProfilerActivity.CPU])


def kineto(prof):
    return {e.name(): e for e in prof.profiler.kineto_results.events()}


def count(recs, name):
    return sum(s.name == name for s in recs)


def named(recs, name):
    return [s for s in recs if s.name == name]


# ------------------------------ the helper ------------------------------


@pytest.mark.parametrize("name", ["ssdn.infer.pad", "ssdn.train.step"])
def test_off_is_the_shared_noop_and_records_nothing(name):
    with profiled():
        with debug.span("ssdn.before"):
            pass
    before = debug.spans()
    off = debug.span(name)
    assert off is debug.span("ssdn.other")
    with off:
        with debug.span(name):
            pass
    assert debug.spans() == before


def test_on_nested_spans_carry_parent_thread_and_duration():
    with profiled() as prof:
        with debug.span("ssdn.t.root"):
            with debug.span("ssdn.t.child"):
                torch.ones(8).sum()
            with debug.span("ssdn.t.child"):
                with debug.span("ssdn.t.grandchild"):
                    pass
    recs = debug.spans()
    assert [s.name for s in recs] == ["ssdn.t.root", "ssdn.t.child",
                                      "ssdn.t.child", "ssdn.t.grandchild"]
    assert [s.parent for s in recs] == [None, 0, 0, 2]
    assert {s.thread for s in recs} == {threading.get_native_id()}
    assert all(s.end_ns >= s.start_ns for s in recs)
    assert recs[0].start_ns <= recs[1].start_ns <= recs[3].end_ns <= (
        recs[0].end_ns)
    assert {"ssdn.t.root", "ssdn.t.child", "ssdn.t.grandchild"} <= set(
        kineto(prof))


def test_main_thread_span_is_on_the_profilers_clock():
    with profiled() as prof:
        for i in range(3):
            with debug.span(f"ssdn.t.clock{i}"):
                torch.ones(64).sum()
    events = kineto(prof)
    for s in debug.spans()[1:]:
        e = events[s.name]
        assert abs(s.start_ns - e.start_ns()) < 1_000_000, s
        assert abs(s.end_ns - e.end_ns()) < 1_000_000, s


def test_worker_thread_span_is_recorded():
    def work():
        with debug.span("ssdn.t.worker"):
            with debug.span("ssdn.t.worker_child"):
                pass

    with profiled():
        with debug.span("ssdn.t.main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    recs = debug.spans()
    (w,), (c,) = named(recs, "ssdn.t.worker"), named(recs, "ssdn.t.worker_child")
    assert w.thread != threading.get_native_id() and c.thread == w.thread
    assert w.parent is None  # the main thread's open span is not its parent
    assert c.parent == recs.index(w)


def test_many_threads_lose_no_span_and_no_parent():
    n_threads, per_thread = 24, 60

    def work(k):
        for _ in range(per_thread):
            with debug.span(f"ssdn.t.outer{k}"):
                with debug.span(f"ssdn.t.inner{k}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiled():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    recs = debug.spans()
    assert len(recs) == 2 * n_threads * per_thread
    for s in recs:
        assert s.end_ns is not None
        if "outer" in s.name:
            assert s.parent is None, s
        else:
            p = recs[s.parent]
            assert p.name == s.name.replace("inner", "outer"), (s, p)
            assert p.thread == s.thread and p.start_ns <= s.start_ns


def test_a_new_session_starts_a_fresh_list_and_reset_empties_it():
    with profile(activities=[ProfilerActivity.CPU]):
        with debug.span("ssdn.t.first"):
            pass
    with debug.span("ssdn.t.between"):  # finds no session
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with debug.span("ssdn.t.second"):
            pass
        with debug.span("ssdn.t.second"):
            pass
    assert [s.name for s in debug.spans()] == ["ssdn.t.second"] * 2
    assert debug.totals()["ssdn.t.second"][0] == 2
    debug.reset()
    assert debug.spans() == [] and debug.totals() == {}


def test_totals_count_closed_spans_and_sum_their_seconds():
    with profiled():
        for _ in range(3):
            with debug.span("ssdn.t.a"):
                pass
        with debug.span("ssdn.t.b"):
            with debug.span("ssdn.t.a"):
                open_totals = debug.totals()
    recs = debug.spans()
    n, secs = debug.totals()["ssdn.t.a"]
    assert n == 4 and secs == pytest.approx(
        sum(s.end_ns - s.start_ns for s in named(recs, "ssdn.t.a")) / 1e9)
    assert open_totals["ssdn.t.a"][0] == 3 and "ssdn.t.b" not in open_totals


def test_a_span_closes_when_its_block_raises():
    with profiled():
        with pytest.raises(ValueError):
            with debug.span("ssdn.t.raises"):
                raise ValueError("x")
        with debug.span("ssdn.t.after"):
            pass
    raised, after = debug.spans()
    assert raised.end_ns is not None and after.parent is None


# ------------------------------ the Trainer ------------------------------


def train(wd, traced, eval_data=None, **kw):
    tr = Trainer(cfg(**kw), str(wd), train_data="synthetic:6:64",
                 eval_data=eval_data, sampler_backend="python",
                 device="cpu", log_interval=0)
    if not traced:
        return tr.train(resume=False), []
    with profiled():
        state = tr.train(resume=False)
    return state, debug.spans()


@pytest.fixture(scope="module")
def trainer_spans(tmp_path_factory):
    return train(tmp_path_factory.mktemp("trace") / "w", True)[1]


@pytest.mark.parametrize("name, want", [
    ("ssdn.trainer.start", 1),
    ("ssdn.trainer.next_batch", STEPS),
    ("ssdn.train.step", STEPS),
    ("ssdn.trainer.guard", STEPS // 2),
    ("ssdn.data.sample", STEPS),
    ("ssdn.trainer.eval", 0),
    ("ssdn.train.allreduce", 0),
    ("ssdn.data.to_device", 0),  # the CPU copies nothing
])
def test_trainer_span_counts(trainer_spans, name, want):
    assert count(trainer_spans, name) == want


def test_trainer_checkpoints_and_closes(trainer_spans):
    ckpt = named(trainer_spans, "ssdn.trainer.checkpoint")
    assert len(ckpt) >= 2  # the last step's save, the closing
    assert all(s.parent is None and s.end_ns is not None for s in ckpt)


def test_step_parts_are_children_of_their_step(trainer_spans):
    recs = trainer_spans
    for part in ("ssdn.train.noise", "ssdn.train.loss", "ssdn.train.backward",
                 "ssdn.train.adam"):
        got = named(recs, part)
        assert len(got) == STEPS, part
        assert all(recs[s.parent].name == "ssdn.train.step" for s in got)
    main = threading.get_native_id()
    assert {s.thread for s in named(recs, "ssdn.train.step")} == {main}
    assert main not in {s.thread for s in named(recs, "ssdn.data.sample")}


def test_eval_spans_hold_their_forwards_and_best_checkpoints(tmp_path):
    # the guard off: a rollback would skip its window's eval
    _, recs = train(tmp_path / "w", True, "synthetic:2:32", eval_interval=2,
                    guard_check=0)
    evals = [i for i, s in enumerate(recs) if s.name == "ssdn.trainer.eval"]
    assert len(evals) == STEPS // 2
    fwd = named(recs, "ssdn.infer.forward")
    assert fwd and all(s.parent in evals for s in fwd)
    assert any(s.parent in evals
               for s in named(recs, "ssdn.trainer.checkpoint"))


def test_trainer_params_bit_equal_traced_and_not(tmp_path):
    on, _ = train(tmp_path / "on", True, iterations=3)
    off, _ = train(tmp_path / "off", False, iterations=3)
    assert on.step == off.step == 3
    for layer, leaf in off.params.items():
        for k, t in leaf.items():
            assert torch.equal(on.params[layer][k], t), (layer, k)


def test_data_parallel_step_has_an_allreduce_span(monkeypatch):
    # a group of one rank: its all-reduce is the identity
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, *a, **k: None)
    group = Group(rank=0, world=1, device=torch.device("cpu"),
                  backend="gloo")
    c = cfg()
    step = make_train_step(c, device="cpu", group=group)
    batch = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                              dtype=np.uint8)
    with profiled():
        step(init_state(c, device="cpu"), batch)
    recs = debug.spans()
    (ar,) = named(recs, "ssdn.train.allreduce")
    assert recs[ar.parent].name == "ssdn.train.step"


# ------------------------------ inference ------------------------------


@pytest.fixture(scope="module")
def model():
    c = cfg()
    return c, init_state(c, device="cpu").params, tfull.make_denoise_fn(
        c, device="cpu")


def noisy(h, w, seed=0):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (h, w, 3)).astype(np.float32)


def test_denoise_image_has_one_of_each_infer_span(model):
    _, params, fn = model
    sigma = np.full((1,), 25 / 255, np.float32)
    with profiled():
        for _ in range(2):
            tfull.denoise_image(fn, params, noisy(40, 50), sigma)
    recs = debug.spans()
    roots = [i for i, s in enumerate(recs) if s.name == "ssdn.infer.request"]
    assert len(roots) == 2
    for part in ("ssdn.infer.pad", "ssdn.infer.to_device",
                 "ssdn.infer.forward", "ssdn.infer.to_host"):
        got = named(recs, part)
        assert [s.parent for s in got] == roots, part


def test_denoise_image_bit_equal_traced_and_not(model):
    _, params, fn = model
    sigma = np.full((1,), 25 / 255, np.float32)
    off = tfull.denoise_image(fn, params, noisy(33, 70, 1), sigma)
    with profiled():
        on = tfull.denoise_image(fn, params, noisy(33, 70, 1), sigma)
    assert np.array_equal(on, off)
    assert count(debug.spans(), "ssdn.infer.request") == 1


@pytest.mark.parametrize("n, eval_batch, forwards", [(3, 1, 3), (3, 2, 2)])
def test_evaluate_dataset_has_one_forward_span_per_forward(
        model, n, eval_batch, forwards):
    c, params, _ = model
    data = open_dataset(f"synthetic:{n}:32")
    with profiled():
        evaluate_dataset(c, params, data, eval_batch=eval_batch, device="cpu")
    assert count(debug.spans(), "ssdn.infer.forward") == forwards
    assert count(debug.spans(), "ssdn.infer.request") == 0
