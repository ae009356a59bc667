"""Captured CUDA graphs of the engine's steps: the port's counterpart of the
jit caches the JAX engine builds (``minigpt4_tpu/engine/engine.py:390-560``,
``StepFns``).

JAX compiles a step once per value of its static arguments and replays the
executable.  Here a step is captured once per key into a
``torch.cuda.CUDAGraph`` and replayed; one replay stands for the thousands
of launches of a decode chunk.  The keys mirror JAX's static arguments:

    decode chunk  (lanes B, steps n, the rows' key: "traced" where the lanes'
                  thresholds are device tensors, else the static configs, as
                  JAX's static scfg or traced rows; bias plane present or
                  not; page-table width or None)
    single step   lanes B
    speculative   (lanes B, verify passes n, width k, None): the n-gram
                  dispatch, greedy ("spec") or sampled ("spec_stoch", with
                  the bias plane present or not); the last slot stands for
                  JAX's attention bucket, which an S = k <= 32 verify does
                  not read (flash decode reads each lane's positions alone)
    prefill       (bucket S, attention span when S > 32, else None)
    encode        image batch

Every value a step reads that changes between calls (cursors, pending
logits, token ids, embeddings, the page table, the bias plane, traced
thresholds, the n-gram history and the residual ban) lives in a static input buffer that a call fills before the
replay; a call hands back copies of the static outputs (token ids, logits,
embeddings), so a later replay cannot overwrite what a caller kept.  The
steps compute positions from the device cursors (``models/llama.py``), so
nothing in them reads a host value.

Capture.  A key's first use runs its step eagerly; its second use captures
it (a key met once, such as a rare bias plane, costs no capture), and
``capture=True`` (the warm-ups) captures on first use.  A capture first
runs the step eagerly once on the capture stream, so that the kernels'
first-use work (``cudaFuncSetAttribute``, the SM-count and occupancy
statics of ``csrc/common.cuh``, the growing workspaces of
``ops/flash_decode.py`` and ``ops/qmm_prefill.py``) happens outside the
capture, then captures it on that stream into the memory pool that every
graph of an engine shares (the steps run one after another, never at
once).  The eager run sees the call's own inputs: it writes exactly the
cache positions the replay then overwrites, past the state's history.

Generators.  Each sampled lane draws from a slot generator of its graph,
registered with it (``CUDAGraph.register_generator_state``).  A call loads
the lane's generator state into the slot before the replay and stores the
slot's state back after it, so a replay draws what the eager loop draws,
and the eager run before a capture leaves the lane's stream as it was.

Launch counters.  The kernel wrappers count launches in Python
(``ops/counters.py``), which a replay does not run.  The counters' deltas
during a capture are recorded, taken back (a capture launches nothing), and
added on every replay.

A capture or replay that fails raises: nothing falls back to eager.
"""

from __future__ import annotations

import torch

from ..models import llama as llama_mod
from ..ops import counters
from ..ops.flash_decode import pos_vector
from .device_sampling import TRACED, LaneRows


def pool_bytes(pool) -> int:
    """Device memory the segments of the graph memory pool ``pool`` hold."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


class _Captured:
    """One captured step: the graph, its static inputs and outputs, its slot
    generators (None for a lane that does not sample) and the launch counts
    of one replay."""

    def __init__(self, graph, inputs: dict, outputs: tuple, slots: list, delta: dict):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.slots, self.delta = slots, delta


def _load(slots: list, generators) -> None:
    for slot, gen in zip(slots, generators):
        if slot is not None:
            slot.set_state(gen.get_state())


def _store(slots: list, generators) -> None:
    for slot, gen in zip(slots, generators):
        if slot is not None:
            gen.set_state(slot.get_state())


class GraphCache:
    """Captured steps by key, on one device, in the memory pool ``pool``
    (``torch.cuda.graph_pool_handle()``; the engine's, shared by all its
    graphs)."""

    def __init__(self, device, pool, eager: bool = False):
        self.device = torch.device(device)
        self.pool = pool
        self.eager = eager  # run every key eagerly, capture none (tp > 1)
        self.stream = None if eager else torch.cuda.Stream(device=self.device)
        self.graphs: dict = {}
        self.seen: set = set()  # keys used once, eagerly
        self.replays = 0  # graph replays so far

    def run(self, key, fn, feed: dict, generators=(), capture: bool = False) -> tuple:
        """Replay the graph of ``key``; on the key's first use run ``fn``
        eagerly instead, and capture it on its second (on the first with
        ``capture``).  ``fn(inputs, generators)`` is the step: it reads the
        input tensors ``inputs`` (named as ``feed``, shaped and typed as its
        tensors) and draws from ``generators`` (one per lane, None where the
        lane does not sample), and returns a tuple of tensors.  For a
        replay, ``feed``'s tensors are copied into the static buffers and
        ``generators`` lend their states to the graph.  Returns the outputs
        (copies of the static ones after a replay).  An ``eager`` cache
        runs ``fn`` every time and records the key in ``seen``."""
        if self.eager:
            self.seen.add(key)
            return tuple(fn(feed, list(generators)))
        graph = self.graphs.get(key)
        if graph is None:
            if not capture and key not in self.seen:
                self.seen.add(key)
                return tuple(fn(feed, list(generators)))
            graph = self.graphs[key] = self._capture(fn, feed, generators)
        for name, t in feed.items():
            graph.inputs[name].copy_(t)
        _load(graph.slots, generators)
        graph.graph.replay()
        self.replays += 1
        _store(graph.slots, generators)
        counters.add(graph.delta)
        return tuple(t.clone() for t in graph.outputs)

    def _capture(self, fn, feed: dict, generators) -> _Captured:
        inputs = {name: t.clone() for name, t in feed.items()}
        slots = [None if g is None else torch.Generator(device=self.device) for g in generators]
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            _load(slots, generators)
            fn(inputs, slots)  # eager: the kernels' first-use work, outside the capture
        _load(slots, generators)
        graph = torch.cuda.CUDAGraph()
        for slot in slots:
            if slot is not None:
                graph.register_generator_state(slot)
        before = counters.counts()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = tuple(fn(inputs, slots))
        finally:
            delta = {k: n - before.get(k, 0) for k, n in counters.counts().items()
                     if n != before.get(k, 0)}
            counters.add(delta, -1)  # the capture launched nothing
        return _Captured(graph, inputs, outputs, slots, delta)


class StepGraphs(GraphCache):
    """The captured decoder steps of one cache: the engine's own state's
    dense cache, or a session pool's page pools.  ``params`` / ``cfg`` are
    the decoder's; ``cache`` is ``{"k", "v"}`` as :func:`llama.forward`
    takes it.  With a tensor-parallel group ``tp`` the steps run on the
    rank's shards, eagerly (gloo's all-reduces cannot be captured);
    ``eager`` runs them eagerly too (the benchmark's steps on the CPU)."""

    def __init__(self, params: dict, cfg, cache: dict, device, pool, tp=None,
                 eager: bool = False):
        super().__init__(device, pool, eager=eager or tp is not None)
        self.params, self.cfg, self.cache, self.tp = params, cfg, cache, tp

    def decode_chunk(self, logits: torch.Tensor, pos0, n: int, generators: list,
                     rows: LaneRows, page_table: torch.Tensor | None = None,
                     capture: bool = False):
        """:func:`llama.decode_loop` of ``n`` steps from the pending logits
        [B, V] at the cursors ``pos0`` (int, B ints or i32 [B]): (token ids
        [B, n], final logits [B, V])."""
        b = logits.shape[0]
        key = ("decode", b, n, rows.key, rows.bias is not None,
               None if page_table is None else page_table.shape[1])
        feed = {"logits": logits, "pos": pos_vector(pos0, b, logits.device)}
        if rows.bias is not None:
            feed["bias"] = rows.bias
        if rows.traced is not None:
            feed.update(rows.traced)
        if page_table is not None:
            feed["table"] = page_table

        def step(inp, gens):
            traced = None if rows.traced is None else {name: inp[name] for name in TRACED}
            return llama_mod.decode_loop(self.params, self.cache, inp["logits"], inp["pos"], n,
                                         gens, LaneRows(rows.configs, inp.get("bias"), traced),
                                         self.cfg, page_table=inp.get("table"), tp=self.tp)

        # traced rows draw on every lane; static ones on the sampled lanes
        gens = [g if rows.traced is not None or not c.greedy else None
                for g, c in zip(generators, rows.configs)]
        return self.run(key, step, feed, gens, capture)

    def spec_chunk(self, logits: torch.Tensor, pos0, hist: torch.Tensor, n_passes: int, k: int,
                   capture: bool = False):
        """:func:`llama.speculative_decode_loop` of ``n_passes`` passes of
        width ``k`` from the pending logits [B, V] at the cursors ``pos0``
        over the histories ``hist`` [B, C]: (tokens [B, n, k], counts [B,
        n], final logits [B, V], hist [B, C])."""
        b = logits.shape[0]
        feed = {"logits": logits, "pos": pos_vector(pos0, b, logits.device), "hist": hist}

        def step(inp, _):
            return llama_mod.speculative_decode_loop(self.params, self.cache, inp["logits"],
                                                     inp["pos"], inp["hist"], n_passes, k,
                                                     self.cfg, tp=self.tp)

        return self.run(("spec", b, n_passes, k, None), step, feed, capture=capture)

    def spec_chunk_stoch(self, logits: torch.Tensor, pos0, hist: torch.Tensor, ban: torch.Tensor,
                         n_passes: int, k: int, generators: list, rows: LaneRows,
                         capture: bool = False):
        """:func:`llama.stochastic_speculative_decode_loop` under the traced
        ``rows``, each lane drawing from its generator, with the carried
        bans ``ban`` [B]: (tokens, counts, final logits, hist, ban)."""
        b = logits.shape[0]
        feed = {"logits": logits, "pos": pos_vector(pos0, b, logits.device), "hist": hist,
                "ban": ban, **rows.traced}
        if rows.bias is not None:
            feed["bias"] = rows.bias

        def step(inp, gens):
            traced = {name: inp[name] for name in TRACED}
            return llama_mod.stochastic_speculative_decode_loop(
                self.params, self.cache, inp["logits"], inp["pos"], inp["hist"], inp["ban"], gens,
                LaneRows(rows.configs, inp.get("bias"), traced), n_passes, k, self.cfg,
                tp=self.tp)

        key = ("spec_stoch", b, n_passes, k, None, rows.bias is not None)
        return self.run(key, step, feed, generators, capture)

    def step(self, tokens: torch.Tensor, pos0, capture: bool = False) -> torch.Tensor:
        """One position per lane, embedding included (JAX's ``decode_step``):
        token ids [B, 1] long at the cursors ``pos0`` -> logits [B, V]."""
        b = tokens.shape[0]
        feed = {"tokens": tokens, "pos": pos_vector(pos0, b, tokens.device)}

        def step(inp, _):
            e = llama_mod.embed_tokens(self.params, inp["tokens"])
            return (llama_mod.forward(self.params, self.cache, e, inp["pos"], self.cfg,
                                      tp=self.tp),)

        return self.run(("step", b), step, feed, capture=capture)[0]

    def prefill(self, embeds: torch.Tensor, pos0: int, last_idx: int, span: int,
                capture: bool = False) -> torch.Tensor:
        """A bucket of S rows [B, S, D] from the cursor ``pos0``: the logits
        [B, V] at row ``last_idx``; ``span`` is the attention bucket the S >
        32 path reads (a key only there: flash decode reads each lane's
        positions alone)."""
        b, s, _ = embeds.shape
        span = span if s > llama_mod.FLASH_DECODE_MAX_S else None
        feed = {"embeds": embeds, "pos": pos_vector(pos0, b, embeds.device),
                "last": torch.full((1,), last_idx, dtype=torch.long, device=embeds.device)}

        def step(inp, _):
            return (llama_mod.forward(self.params, self.cache, inp["embeds"], inp["pos"],
                                      self.cfg, inp["last"], attn_len=span, tp=self.tp),)

        return self.run(("prefill", s, span), step, feed, capture=capture)[0]
