"""Stand-ins for torch.cuda's graph API on the CPU, for the port's tests of
its captured steps (``minigpt4_tpu_torch/engine/graphs.py``), and the guard
that makes every host read of a tensor raise.

``fake_cuda``: a capture runs its step eagerly inside the context and
records the graph; a replay only counts itself and draws once from each
registered generator (what the graph cache's bookkeeping needs).

``replay_cuda``: a replay runs the captured step again on the graph's own
static inputs, the buffers the step was captured over and the graph's slot
generators, and writes its results into the graph's static outputs, as a
CUDA graph replays its kernels on fixed addresses: a replay computes from
what those hold at replay time, so a step whose buffers do not hold the
state it is replayed for gives other bits than the eager step.  (The
plain CPU versions of the kernels read cursors on the host, as a kernel
does on the card, so the step is run again rather than its recorded
operations.)
"""

import contextlib

import pytest
import torch
from minigpt4_tpu_torch.engine import engine as engine_mod
from minigpt4_tpu_torch.engine import graphs


class _HostRead(AssertionError):
    pass


@contextlib.contextmanager
def _no_host_reads():
    """Make every way of reading a tensor on the host, or of copying host
    data into one, raise: on the card each is a copy that a capture
    refuses (a 0-d tensor used as an index is read on the host, a Python
    number stored into a tensor element is copied from it)."""
    def refuse(*a, **k):
        raise _HostRead("a captured step read a host value")

    getitem, setitem = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def host_index(index):  # a 0-d tensor index is read on the host
        parts = index if isinstance(index, tuple) else (index,)
        return any(isinstance(i, torch.Tensor) and i.dim() == 0 for i in parts)

    def load(t, index):
        if host_index(index):
            refuse()
        return getitem(t, index)

    def store(t, index, value):
        if host_index(index) or not isinstance(value, torch.Tensor):
            refuse()
        setitem(t, index, value)

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "cpu", "__bool__"):
            mp.setattr(torch.Tensor, name, refuse)
        mp.setattr(torch.Tensor, "__getitem__", load)
        mp.setattr(torch.Tensor, "__setitem__", store)
        mp.setattr(torch, "tensor", refuse)
        yield


class _FakeGraph:
    """Stand-in for torch.cuda.CUDAGraph: counts captures and replays; a
    replay draws once from each registered generator, as a captured draw
    advances it."""

    def __init__(self):
        self.replays = 0
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        for g in self.generators:
            torch.rand(1, generator=g)


class _FakeStream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


class _ReplayGraph(_FakeGraph):
    """A graph whose replay runs its step again (``step``: the step, its
    static inputs and outputs and its slot generators, set at the capture)
    and copies the results into the static outputs."""

    step = None

    def replay(self):
        self.replays += 1
        fn, inputs, outputs, slots = self.step
        for o, r in zip(outputs, fn(inputs, slots)):
            o.copy_(r)


def _patch(monkeypatch, graph_cls, rerun: bool) -> list:
    captured = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local" and pool == "pool"
        captured.append(g)
        yield

    if rerun:
        capture = graphs.GraphCache._capture

        def capture_step(self, fn, feed, generators):
            cap = capture(self, fn, feed, generators)
            cap.graph.step = (fn, cap.inputs, cap.outputs, cap.slots)
            return cap

        monkeypatch.setattr(graphs.GraphCache, "_capture", capture_step)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph_cls)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(engine_mod, "pool_bytes", lambda pool: 0)
    return captured


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph API stood in for on the CPU: a capture runs its
    step eagerly inside the context and records the graph."""
    return _patch(monkeypatch, _FakeGraph, rerun=False)


@pytest.fixture
def replay_cuda(monkeypatch):
    """torch.cuda's graph API stood in for on the CPU by graphs that run
    their step again on replay (:class:`_ReplayGraph`); the captured graphs
    in capture order."""
    return _patch(monkeypatch, _ReplayGraph, rerun=True)
