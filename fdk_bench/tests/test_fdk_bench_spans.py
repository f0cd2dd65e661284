"""The readers of the program's spans (``metrics/step_*_ms.py``,
``lib/spans.py``) on a canned ``collected()`` of the program's tracer,
and on none."""

import pytest

from fdk_bench import run as R

READERS = {"step_prep_ms": ("step.prep", "device_s"),
           "step_filter_ms": ("step.filter", "device_s"),
           "step_k1_ms": ("step.k1", "device_s"),
           "step_host_ms": ("step", "host_s")}
TRACED = {"trace": {"block": {"busy_s": 1.0, "window_s": 1.0}}}
COLLECTED = {"spans": {
    "step": {"count": 4, "host_s": 0.002, "self_host_s": 0.001,
             "device_s": None},
    "step.prep": {"count": 4, "host_s": 1e-4, "self_host_s": 1e-4,
                  "device_s": 0.004},
    "step.filter": {"count": 4, "host_s": 1e-4, "self_host_s": 1e-4,
                    "device_s": 0.002},
    "step.k1": {"count": 4, "host_s": 2e-4, "self_host_s": 2e-4,
                "device_s": 0.1}},
    "counters": {"steps": 4}}
WANT = {"step_prep_ms": 1.0, "step_filter_ms": 0.5, "step_k1_ms": 25.0,
        "step_host_ms": 0.5}


def read(name, record):
    return R.load_module("metric", name).read(record)


@pytest.fixture
def collected(monkeypatch):
    from paris_tpu_torch.utils import profiling

    def use(value):
        monkeypatch.setattr(profiling, "collected", lambda: value)
    return use


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_canned_record(collected, name):
    collected(COLLECTED)
    assert read(name, TRACED) == pytest.approx(WANT[name])
    # a run that traced no block pass reads nothing
    assert read(name, {"trace": {}}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_none(collected, name):
    collected(None)
    assert read(name, TRACED) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_its_span(collected, name):
    span, key = READERS[name]
    spans = {k: v for k, v in COLLECTED["spans"].items() if k != span}
    collected({"spans": spans, "counters": {}})
    assert read(name, TRACED) is None
    collected({"spans": dict(spans, **{span: dict(
        COLLECTED["spans"][span], **{key: None})}), "counters": {}})
    assert read(name, TRACED) is None


def test_readers_on_a_program_without_the_tracer(monkeypatch):
    """A program whose ``utils.profiling`` has no ``collected`` (before
    the tracer) reads nothing and raises nothing."""
    from paris_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "collected")
    for name in READERS:
        assert read(name, TRACED) is None
