"""The port's spans (``egc_tpu_torch.utils.profiling.span``) and the
benchmark's attribution of time to them (``gnnbench/spans.py``), on the
CPU: the shared no-op while nothing reads the spans, every span of a
full-graph step under a profiler and nested as the step runs them, the
host time of every operation charged to a module span (backward nodes
through their forward link), bit-identical training with spans on and
off, a trial's phases counted by ``span_totals``, the attribution of
device time and idle gaps on a hand-made trace with a backward thread,
and the per-layer numbers read from hand-made records."""

import types
from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from egc_tpu_torch.data import synthetic
from egc_tpu_torch.exp import fullgraph as fg
from egc_tpu_torch.exp.runner import run_trial
from egc_tpu_torch.utils import profiling
from egc_tpu_torch.utils.profiling import NO_SPAN, span, span_totals
from gnnbench import spans

torch.set_num_threads(2)
HP = {"lr": 0.01, "wd": 5e-4, "dropout": 0.2}

# Each span of a step and the span it runs inside (None: outermost).
PARENT = {
    "egc.step": None,
    "egc.forward": "egc.step", "egc.loss": "egc.step",
    "egc.backward": "egc.step", "egc.optimizer": "egc.step",
    "egc.embed": "egc.forward", "egc.conv": "egc.forward",
    "egc.norm": "egc.forward", "egc.pointwise": "egc.forward",
    "egc.head": "egc.forward",
    "egc.conv.dense": "egc.conv", "egc.aggregate": "egc.conv",
    "egc.headmix": "egc.conv",
}
LAYERS = {"arxiv": 3, "mag": 2}
# Calls of each span in one step: ArxivNet has the input Linear and a
# BatchNorm a layer, MagNet neither, and its pointwise runs between layers.
ONCE = ("egc.step", "egc.forward", "egc.loss", "egc.backward", "egc.head")
PER_LAYER = ("egc.conv", "egc.conv.dense", "egc.aggregate", "egc.headmix")


def expected_counts(kind: str) -> Counter:
    n = LAYERS[kind]
    want = Counter({s: 1 for s in ONCE})
    want.update({s: n for s in PER_LAYER})
    want["egc.optimizer"] = 2                  # zero_grad, then step
    if kind == "arxiv":
        want.update({"egc.embed": 1, "egc.norm": n, "egc.pointwise": n})
    else:
        want["egc.pointwise"] = n - 1
    return want


def small_config(kind: str):
    """The CLI's configuration of ``kind`` on a 300-node graph on the
    CPU (arxiv: EGC-M H4 B4 symnorm / max / mean)."""
    if kind == "arxiv":
        cfg = fg.ArxivConfig("egc", 16, heads=4, bases=4,
                             aggrs=("symnorm", "max", "mean"), device="cpu")
        classes = 40
    else:
        cfg = fg.MagConfig("egc", 16, heads=2, bases=2, device="cpu")
        classes = 349
    raw = synthetic.synthetic_full_graph(num_nodes=300, avg_degree=6,
                                         num_classes=classes,
                                         num_features=32)
    cfg.load_full_graph = lambda: raw
    return cfg


def start(kind: str):
    cfg = small_config(kind)
    data = cfg.data(HP)
    model = cfg.model(HP, seed=0)
    state = cfg.init_state(model, HP, data, 0)
    return cfg, model, state, data, cfg.rng(0)


def profiled_step(kind: str):
    """A step, then a second one under a CPU profiler."""
    cfg, model, state, data, rng = start(kind)
    cfg.train(model, state, data, rng, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cfg.train(model, state, data, rng, 1)
    return prof


def nearest_span(evt):
    p = evt.cpu_parent
    while p is not None and not p.name.startswith(spans.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name


def test_span_is_the_shared_noop_while_nothing_reads_it():
    assert span("egc.step") is NO_SPAN
    with span("egc.step") as s:
        assert s is None
    with span_totals() as totals:
        assert span("egc.step") is not NO_SPAN
        with span("egc.step"):
            with span("egc.norm"):
                pass
        with span("egc.norm"):
            pass
    assert span("egc.step") is NO_SPAN
    assert {k: v[1] for k, v in totals.items()} == \
        {"egc.step": 1, "egc.norm": 2}
    assert totals["egc.step"][0] >= totals["egc.norm"][0] / 2 > 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("egc.step") is not NO_SPAN
    assert span("egc.step") is NO_SPAN


def test_span_totals_nest_and_restore_the_outer_collector():
    with span_totals() as outer:
        with span("a"):
            with span_totals() as inner:
                with span("b"):
                    pass
        with span("c"):
            pass
    assert set(inner) == {"b"}
    assert set(outer) == {"a", "c"}
    assert profiling._totals is None


@pytest.mark.parametrize("kind", ["arxiv", "mag"])
def test_a_step_under_the_profiler_shows_every_span_nested(kind):
    prof = profiled_step(kind)
    evts = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    assert Counter(e.name for e in evts) == expected_counts(kind)
    for e in evts:
        assert nearest_span(e) == PARENT[e.name], e.name
        if PARENT[e.name] is not None:
            outer = e.cpu_parent
            while outer.name != PARENT[e.name]:
                outer = outer.cpu_parent
            assert outer.time_range.start <= e.time_range.start
            assert e.time_range.end <= outer.time_range.end


@pytest.mark.parametrize("kind", ["arxiv", "mag"])
def test_spans_charge_every_op_to_a_module(kind):
    """Every aten op of the forward, and every backward node with a
    forward link, counts under a module span; under 5% of the aten ops'
    host self time is left unattributed (the loss gradient's seed and
    the gradients' accumulation)."""
    prof = profiled_step(kind)
    events = prof.events()
    span_of = spans.span_resolver(events)
    fwd_ops = [e for e in events if e.name.startswith("aten::")
               and _inside(e, "egc.forward")]
    nodes = [e for e in events if e.fwd_thread > 0 and e.sequence_nr >= 0]
    assert fwd_ops and nodes
    for e in fwd_ops + nodes:
        assert spans.is_module(span_of(e)), (e.name, span_of(e))
    backward_spans = {span_of(e) for e in nodes}
    assert {"egc.conv.dense", "egc.aggregate", "egc.headmix",
            "egc.head", "egc.loss"} <= backward_spans
    if kind == "arxiv":
        assert {"egc.embed", "egc.norm", "egc.pointwise"} <= backward_spans
    by = spans.host_self_by_span(prof)
    assert spans.unattributed(by) < 0.05 * sum(by.values())
    assert spans.device_by_span(prof) == {}
    assert spans.gaps_by_span(prof) == []


def _inside(evt, name):
    p = evt.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def _train(kind: str, steps: int, traced: bool):
    cfg, model, state, data, rng = start(kind)
    losses = []
    for it in range(steps):
        if traced:
            with profile(activities=[ProfilerActivity.CPU]), span_totals():
                _, m = cfg.train(model, state, data, rng, it)
        else:
            _, m = cfg.train(model, state, data, rng, it)
        losses.append(m["train_loss"])
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    weights = {k: p.detach().clone() for k, p in model.named_parameters()}
    return losses, grads, weights


@pytest.fixture
def one_thread():
    """The CPU's scatter-adds sum in an order that varies with more than
    one thread; with one, two runs of the same steps agree to the bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", ["arxiv", "mag"])
def test_training_is_bit_identical_with_spans_on_and_off(kind, one_thread):
    off = _train(kind, 2, traced=False)
    on = _train(kind, 2, traced=True)
    assert on[0] == off[0]
    for got, want in zip(on[1:], off[1:]):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_a_trial_counts_its_phases(tmp_path):
    cfg = small_config("arxiv")
    saved = []
    persist = cfg.persist_trial

    def counting_persist(*args, **kwargs):
        saved.append(1)
        return persist(*args, **kwargs)

    cfg.persist_trial = counting_persist
    with span_totals() as totals:
        out = run_trial(cfg, dict(HP), max_iterations=3, patience=10,
                        trial_dir=tmp_path / "trial",
                        report=lambda it, row: False, verbose=False)
    assert len(out["history"]) == 3 and saved
    calls = {k: v[1] for k, v in totals.items()}
    for phase in ("train", "val", "plateau", "report"):
        assert calls[f"egc.trial.{phase}"] == 3
    # the checkpoints of the loop; the one at a trial's end is outside it
    assert calls["egc.trial.persist"] == len(saved) - 1
    assert calls["egc.checkpoint.save"] == len(saved)
    assert calls["egc.step"] == 3
    assert totals["egc.trial.train"][0] >= totals["egc.step"][0]


# ---------------------------------------------------------------------------
# attribution on a hand-made trace: a forward on thread 1, its backward on
# thread 2 (autograd's device thread), kernels on the card
# ---------------------------------------------------------------------------

def _evt(name, a, b, *, parent=None, thread=1, seq=-1, fwd=0, dev=False,
         link=0, eid=0, mark=False):
    return types.SimpleNamespace(
        name=name, id=eid, cpu_parent=parent, thread=thread,
        sequence_nr=seq, fwd_thread=fwd, is_async=False,
        is_user_annotation=mark, linked_correlation_id=link, kernels=[],
        device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=a, end=b),
        self_cpu_time_total=b - a)


def _card_trace(linked: bool = True):
    """With ``linked``, each device event names its host operation
    (``linked_correlation_id``, torch 2.13); without, each host operation
    lists what it launched (``kernels``, torch 2.11), the span's device
    mark and a runtime call's entry among them."""
    step = _evt("egc.step", 0, 1000, eid=1)
    fwd = _evt("egc.forward", 0, 300, parent=step, eid=2)
    norm = _evt("egc.norm", 10, 80, parent=fwd, eid=3)
    mul = _evt("aten::mul", 20, 60, parent=norm, seq=7, eid=4)
    bwd = _evt("egc.backward", 400, 900, parent=step, eid=5)
    ones = _evt("aten::ones_like", 410, 420, parent=bwd, eid=6)
    node = _evt("autograd::engine::evaluate_function: MulBackward0",
                500, 700, thread=2, seq=7, fwd=1, eid=7)
    bmul = _evt("aten::mul", 510, 690, parent=node, thread=2, eid=8)
    launch = _evt("cudaLaunchKernel", 520, 530, parent=bmul, thread=2,
                  link=8, eid=9)
    host = [step, fwd, norm, mul, bwd, ones, node, bmul, launch]
    kernels = [
        _evt("mul_kernel", 30, 90, dev=True, link=4, eid=4),     # norm
        _evt("fill_kernel", 430, 440, dev=True, link=6, eid=6),  # backward
        _evt("mul_kernel", 540, 640, dev=True, link=8, eid=8),   # norm
        _evt("memset", 650, 655, dev=True, link=99, eid=99),     # unlinked
        _evt("egc.norm", 30, 90, dev=True, link=3, eid=3, mark=True),
    ]
    if not linked:
        entry = types.SimpleNamespace
        for e in host + kernels:
            del e.linked_correlation_id
        mul.kernels = [entry(name="mul_kernel", duration=60)]
        ones.kernels = [entry(name="fill_kernel", duration=10)]
        bmul.kernels = [entry(name="mul_kernel", duration=100)]
        norm.kernels = [entry(name="egc.norm", duration=60)]
        launch.kernels = [entry(name="mul_kernel", duration=100)]
    return types.SimpleNamespace(events=lambda: host + kernels)


@pytest.mark.parametrize("linked", [True, False])
def test_device_time_follows_the_forward_link_across_threads(linked):
    by = spans.device_by_span(_card_trace(linked))
    assert by == pytest.approx({"egc.norm": 160e-6, "egc.backward": 10e-6,
                                spans.UNLINKED: 5e-6})
    assert spans.unattributed(by) == pytest.approx(15e-6)


def test_gaps_go_to_the_span_running_when_they_begin():
    """Gaps 90-430 (egc.forward open, egc.norm closed), 440-540
    (egc.backward; the node has not begun) and 640-650 (the backward
    node's mul, linked to egc.norm)."""
    got = dict(spans.gaps_by_span(_card_trace()))
    assert got == pytest.approx({"egc.forward": 340e-6,
                                 "egc.backward": 100e-6,
                                 "egc.norm": 10e-6})


# ---------------------------------------------------------------------------
# the per-layer numbers of a run's records
# ---------------------------------------------------------------------------

FULL = {"mode": "full", "window_s": 30.0, "steps": 1000,
        "profile": {"steps": 5, "busy_s": 0.2,
                    "span_device_s": {"egc.norm": 0.02, "egc.conv": 0.17,
                                      "egc.optimizer": 0.002,
                                      "egc.backward": 0.006,
                                      spans.UNLINKED: 0.002}}}
TRIAL = {"mode": "trial", "window_s": 20.0, "steps": 500,
         "span_host_s": {"egc.trial.val": [3.0, 500],
                         "egc.trial.persist": [0.5, 12]}}


@pytest.mark.parametrize("read, want", [
    (lambda r: spans.module_ms(r, "egc.norm"), 4.0),
    (lambda r: spans.module_ms(r, "egc.optimizer"), 0.4),
    (lambda r: spans.module_ms(r, "egc.pointwise"), 0.0),
    (spans.unattributed_share, 4.0),
])
def test_full_records_read(read, want):
    assert read(FULL) == pytest.approx(want)
    assert read(TRIAL) is None
    assert read({"mode": "full", "window_s": 1.0, "steps": 1}) is None
    assert read({"mode": "full", "profile": {"steps": 5, "busy_s": 0.1}}) \
        is None


@pytest.mark.parametrize("name, want", [
    ("egc.trial.val", 15.0), ("egc.trial.persist", 2.5),
    ("egc.trial.report", 0.0)])
def test_trial_records_read(name, want):
    assert spans.host_share(TRIAL, name) == pytest.approx(want)
    assert spans.host_share(FULL, name) is None
    assert spans.host_share({"mode": "trial", "window_s": 1.0}, name) \
        is None
