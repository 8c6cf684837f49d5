"""The span readers (``portbench/spans.py``) on hand-placed traces: device
activities and program spans laid out by hand, the numbers worked out by
hand.  And a tiny traced run of a sample cell and of a train cell on the
CPU, which reads each span metric or leaves it out without error."""
import math
import random
from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.tests.test_portbench_runs import BENCH, _run

SPAN_METRICS = ["denoiser_ms.sample", "sampler_own_pct.sample", "loop_idle_ms.sample",
                "edge_idle_ms.sample", "weight_cast_mb.sample", "update_idle_ms.train",
                "fwd_bwd_idle_ms.train", "update_host_ms.train", "encode_pct.train"]


def _span(sid, name, start_us, end_us, parent=None, root=None, thread=1, device_ms=None,
          counts=None):
    return SimpleNamespace(id=sid, name=name, parent=parent, root=root or sid, thread=thread,
                           start_ns=int(start_us * 1e3), end_ns=int(end_us * 1e3),
                           device_ms=device_ms, counts=counts)


def _ops(*pairs):
    return [("k", float(s), float(e)) for s, e in pairs]


def _trace(device_ops, units=1, host_units=0):
    return harness.Trace(None, units, 1.0, device_ops, {}, {}, host_units=host_units)


@pytest.fixture
def recorded(monkeypatch):
    """Hands ``spans`` the given list as the program's recorded spans."""
    def use(items):
        monkeypatch.setattr(spans, "program_spans", lambda: list(items))
    return use


def _by_id(ops, items):
    out, total = spans.idle_by_span(ops, items)
    assert math.isclose(sum(out.values()), total, rel_tol=1e-12, abs_tol=1e-15)
    return {k: round(v * 1e6, 6) for k, v in out.items()}, round(total * 1e6, 6)


def test_a_gap_straddling_two_spans_is_split_by_overlap():
    items = [_span(1, "request", 0, 100), _span(2, "a", 10, 40, 1, 1),
             _span(3, "b", 40, 90, 1, 1)]
    got, total = _by_id(_ops((0, 20), (60, 100)), items)
    assert got == {2: 20.0, 3: 20.0} and total == 40.0


def test_idle_while_no_span_is_open_is_unspanned():
    items = [_span(1, "request", 0, 50), _span(2, "request", 70, 120)]
    got, total = _by_id(_ops((0, 40), (90, 120)), items)
    assert got == {1: 10.0, None: 20.0, 2: 20.0} and total == 50.0


def test_the_window_reaches_from_the_first_root_to_the_last_activity():
    # the card starts 15 us after the request opens and runs 20 us past its end
    items = [_span(1, "request", 0, 100), _span(2, "sample", 30, 80, 1, 1)]
    got, total = _by_id(_ops((15, 40), (50, 120)), items)
    assert got == {1: 15.0, 2: 10.0} and total == 25.0


def test_a_span_of_a_second_thread_lies_under_the_span_it_joined():
    """Autograd's device thread opens the GroupNorm backward's span under
    the main thread's ``train.backward``: deeper, so innermost across it."""
    items = [_span(1, "train.step", 0, 100), _span(2, "train.backward", 10, 90, 1, 1),
             _span(3, "GroupNormSiLU.backward", 30, 50, 2, 1, thread=2)]
    got, total = _by_id(_ops((0, 20), (40, 60), (80, 100)), items)
    assert got == {2: 30.0, 3: 10.0} and total == 40.0


def test_of_two_open_spans_at_one_depth_the_later_one_is_innermost():
    items = [_span(1, "train.step", 0, 100), _span(2, "x", 10, 60, 1, 1),
             _span(3, "y", 40, 80, 1, 1, thread=2)]
    got, _ = _by_id(_ops((0, 20), (90, 100)), items)
    assert got == {2: 20.0, 3: 40.0, 1: 10.0}


def test_every_idle_microsecond_is_put_down_once():
    """The identity: each span's idle plus the unspanned idle is the
    window's idle, on random nested spans over two threads."""
    rng = random.Random(5)
    for trial in range(50):
        items, sid, t = [], 0, 0.0
        for _ in range(rng.randint(1, 4)):  # roots, with gaps between them
            t += rng.uniform(0, 30)
            sid += 1
            root = _span(sid, "request", t, t + rng.uniform(50, 200))
            items.append(root)
            stack = [root]
            for _ in range(rng.randint(0, 8)):
                parent = rng.choice(stack)
                a = rng.uniform(parent.start_ns, parent.end_ns) / 1e3
                b = rng.uniform(a, parent.end_ns / 1e3)
                sid += 1
                child = _span(sid, "c", a, b, parent.id, root.id, thread=rng.choice([1, 2]))
                items.append(child)
                stack.append(child)
            t = root.end_ns / 1e3
        ops, u = [], rng.uniform(0, 20)
        while u < t + 30:
            d = rng.uniform(0.5, 15)
            ops.append(("k", u, u + d))
            u += d + rng.choice([0.0, rng.uniform(0, 25)])
        rng.shuffle(ops)
        out, total = spans.idle_by_span(ops, items)
        runs = spans.busy(ops)
        lo = min(runs[0][0], min(s.start_ns for s in items) / 1e3)
        hi = max(runs[-1][1], max(s.end_ns for s in items) / 1e3)
        assert math.isclose(total, (hi - lo - sum(e - s for s, e in runs)) / 1e6,
                            rel_tol=1e-9, abs_tol=1e-12), trial
        assert math.isclose(sum(out.values()), total, rel_tol=1e-9, abs_tol=1e-12), trial


def test_the_card_only_window_is_the_first_units_of_the_last_roots(recorded):
    """Three requests recorded: an earlier run's, then the card-only
    sub-window's (units 1), then the host sub-window's (host_units 1)."""
    items = [_span(1, "request", 0, 10), _span(2, "sample", 1, 9, 1, 1),
             _span(3, "request", 20, 30), _span(4, "sample", 21, 29, 3, 3),
             _span(5, "request", 40, 50), _span(6, "sample", 41, 49, 5, 5)]
    recorded(items)
    assert [s.id for s in spans.window_spans(_trace([], 1, 1))] == [3, 4]
    assert [s.id for s in spans.window_spans(_trace([], 2, 1))] == [1, 2, 3, 4]


def _request(base, sid):
    """A request at ``base`` us: text_encode, a sample of two denoiser calls,
    decode, to_host; device extents and weight casts set by hand."""
    r = sid
    return [_span(r, "request", base, base + 100, device_ms=0.09),
            _span(r + 1, "text_encode", base + 2, base + 10, r, r, device_ms=0.008),
            _span(r + 2, "sample", base + 10, base + 70, r, r, device_ms=0.06),
            _span(r + 3, "denoiser", base + 12, base + 30, r + 2, r, device_ms=0.02,
                  counts={"weight_cast_bytes": 3_000_000}),
            _span(r + 4, "denoiser", base + 40, base + 60, r + 2, r, device_ms=0.03,
                  counts={"weight_cast_bytes": 3_000_000}),
            _span(r + 5, "decode", base + 70, base + 90, r, r, device_ms=0.015),
            _span(r + 6, "to_host", base + 90, base + 100, r, r)]


def test_sample_readers_by_hand(recorded):
    recorded(_request(0, 1) + _request(200, 11))
    # per request: busy [0,5] [15,35] [45,65] [75,85] [95,100] (us from its start)
    ops = []
    for base in (0, 200):
        ops += _ops(*[(base + a, base + b) for a, b in
                      ((0, 5), (15, 35), (45, 65), (75, 85), (95, 100))])
    trace = _trace(ops, units=2)
    read = {name: _reader(name)(trace) for name in SPAN_METRICS if name.endswith(".sample")}
    assert read["denoiser_ms.sample"] == pytest.approx(0.025)
    assert read["sampler_own_pct.sample"] == pytest.approx(100 * (1 - 0.05 / 0.06))
    # idle in the loop: [10,12] sample, [12,15] denoiser, [35,40] sample,
    # [40,45] denoiser, [65,70] sample: 20 us
    assert read["loop_idle_ms.sample"] == pytest.approx(0.020)
    # outside it: [5,10] text_encode, [70,75] and [85,90] decode, [90,95]
    # to_host: 20 us
    assert read["edge_idle_ms.sample"] == pytest.approx(0.020)
    assert read["weight_cast_mb.sample"] == pytest.approx(3.0)
    # unspanned: [100, 200] between the requests
    by_name, total = spans.idle_by_name(trace)
    assert by_name[spans.UNSPANNED] == pytest.approx(100e-6)
    assert sum(by_name.values()) == pytest.approx(total)


def test_train_readers_by_hand(recorded):
    items = [
        _span(1, "train.step", 0, 200, device_ms=0.2),
        _span(2, "train.forward", 5, 60, 1, 1),
        _span(3, "vae.encode", 6, 20, 2, 1, device_ms=0.03),
        _span(4, "text_encode", 20, 25, 2, 1, device_ms=0.01),
        _span(5, "denoiser", 25, 60, 2, 1, device_ms=0.05),
        _span(6, "train.backward", 60, 120, 1, 1),
        _span(7, "GroupNormSiLU.backward", 70, 90, 6, 1, thread=2),
        _span(8, "train.clip", 120, 130, 1, 1),
        _span(9, "train.optimizer", 130, 180, 1, 1),
        _span(10, "train.ema", 180, 198, 1, 1),
    ]
    recorded(items)
    ops = _ops((0, 30), (40, 80), (85, 125), (140, 150), (190, 200))
    trace = _trace(ops, units=1, host_units=0)
    read = {name: _reader(name)(trace) for name in SPAN_METRICS if name.endswith(".train")}
    # [30,40]: denoiser (forward); [80,85]: GroupNorm backward (backward)
    assert read["fwd_bwd_idle_ms.train"] == pytest.approx(0.015)
    # [125,130] clip, [130,140] and [150,180] optimizer, [180,190] ema
    assert read["update_idle_ms.train"] == pytest.approx(0.055)
    assert read["update_host_ms.train"] == pytest.approx(0.068)
    assert read["encode_pct.train"] == pytest.approx(20.0)


def test_readers_find_nothing_without_spans_or_activities(recorded):
    recorded([])
    trace = _trace(_ops((0, 10)), units=1)
    for name in SPAN_METRICS:
        assert _reader(name)(trace) is None, name
    recorded(_request(0, 1))
    no_card = _trace([], units=1)
    for name in ("loop_idle_ms.sample", "edge_idle_ms.sample"):
        assert _reader(name)(no_card) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_spans(name, *args, **kwargs):
        if name == "dmtpu_torch.utils.profiling":
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    assert spans.program_spans() is None
    assert spans.window_spans(_trace([], 1)) == []


def _reader(name):
    from portbench import run

    return run._metric_reader(name)


CELLS = {"sd15.txt2img.b16": "sample", "dit-xl2.train.b64": "train"}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_tiny_traced_run_reads_the_span_metrics(name):
    """On the CPU there are no device activities and no CUDA events: the
    readers of those leave their metric out; the host's and the count's read."""
    _, result = _run(name, trace=1, f32=False)
    listed = {m["name"] for m in BENCH["per_layer"] if name in m.get("workloads", [])}
    mine = [m for m in SPAN_METRICS if m in listed]
    assert mine
    for metric in mine:
        if metric in result["metrics"]:
            assert math.isfinite(result["metrics"][metric]["value"]), metric
    if CELLS[name] == "train":
        assert result["metrics"]["update_host_ms.train"]["value"] > 0
    else:
        assert result["metrics"]["weight_cast_mb.sample"]["value"] > 0
