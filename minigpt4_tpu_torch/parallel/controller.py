"""The rank-0 controller of serving over tensor-parallel ranks.

The JAX package serves a mesh from one controller: one process drives every
device.  The port runs one process per rank, and every rank must run the
same device operations, with the same arguments, in the same order, or the
ranks' collectives pair up wrongly and hang.  The HTTP front, its threads
and the batchers' worker threads run on rank 0 alone; this module replays
what they do to the model on the other ranks (the followers).

Every device-touching method of ``SessionPool``, ``ChatSession`` and
``ContinuousBatcher`` carries :func:`replicated` (or, for a generator,
:func:`replicated_stream`).  On rank 0 such a call becomes one operation:
under one order lock, rank 0 broadcasts ``(op, object, method, args)``
(sessions by id) to the followers and then runs the call itself; each
follower's :meth:`Controller.follow` loop applies the same call to its own
replica (a pool built with the same arguments, its sessions and batchers
keyed alike).  A call made inside an operation runs directly on each rank.
A generator method is three kinds of operation: open, each ``next`` and
close, so a stream that the client abandons closes on every rank.  The
broadcasts go over a CPU gloo group of their own, not the tp group (with
NCCL on several cards an object broadcast there would go through CUDA).

Agreement: after every operation every rank sends its outcome (a digest of
the result: token ids and strings, session ids, shapes, or the exception)
to all others.  Equal outcomes go on (an exception every rank raised
reaches rank 0's caller, and the followers go on); unequal ones mean that
the ranks diverged (a follower failed alone, or drew other ids): the
controller is broken, the caller gets an error naming every rank's outcome,
every later call fails at once, and the followers leave their loop with the
error.  No operation falls back or retries.

Every collective of the CPU group has a deadline (``timeout_s``); while no
request arrives, rank 0 sends a no-op every ``timeout_s / 4`` seconds, so a
follower waiting for work is never past its deadline, and one whose leader
died fails within it.  A follower that fails inside an operation while rank
0 waits in one of the operation's tp collectives cannot tell rank 0 so: it
waits for the outcomes until the deadline, then leaves (a spawned rank
exits), which ends rank 0's collective with an error; rank 0's controller
is then broken as well.  :meth:`Controller.stop` broadcasts the end.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


class _Ref:
    """An object named on the wire: ("session", id), ("obj", id) or
    ("pool",)."""

    __slots__ = ("key",)

    def __init__(self, *key):
        self.key = key


class _Discard:
    """The token queue of a follower's batcher lane: nothing reads it."""

    def put(self, _item) -> None:
        pass


class ReplicaDiverged(RuntimeError):
    """The ranks' outcomes of one operation differ."""


def _digest(x) -> str:
    """What every rank must agree on about a result: ids, strings and
    structure exactly, arrays by shape and type (their values may differ
    in the last bits between ranks)."""
    from ..engine.sessions import ChatSession

    if x is None or isinstance(x, (bool, int, str, float)):
        return repr(x)
    if isinstance(x, (list, tuple)):
        return "[" + ",".join(_digest(v) for v in x) + "]"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k!r}:{_digest(v)}" for k, v in x.items()) + "}"
    if isinstance(x, ChatSession):
        return f"session {x.session_id}"
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return f"array {tuple(x.shape)} {x.dtype}"
    return type(x).__name__


class Controller:
    """One rank's end of the replication of ``pool``'s operations over the
    default process group (world = the tp ranks).  Rank 0 leads: its
    replicated calls broadcast; every other rank runs :meth:`follow`.
    Collective: every rank makes its controller at the same point."""

    def __init__(self, pool, timeout_s: float = 300.0):
        self.pool = pool
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.leader = self.rank == 0
        self.timeout_s = timeout_s
        self.group = dist.new_group(backend="gloo", timeout=timedelta(seconds=timeout_s))
        self.broken: str | None = None
        self.ops = 0
        self._lock = threading.RLock()
        self._local = threading.local()
        self._objects: dict[int, object] = {}
        self._streams: dict[int, object] = {}
        self._next_id = 0
        self._pending_closes: list[int] = []
        self._last_op = time.monotonic()
        self._stopped = threading.Event()
        pool._ctl = self
        if self.leader:
            threading.Thread(target=self._heartbeat, daemon=True).start()

    # -- rank 0 --
    def leading(self) -> bool:
        """True where a replicated call must broadcast: on rank 0, outside
        any operation of this thread."""
        return self.leader and not getattr(self._local, "depth", 0)

    def call(self, obj, name: str, args: tuple, kwargs: dict):
        """``obj.name(*args, **kwargs)`` on every rank; rank 0's result."""
        with self._lock:
            self._begin()
            return self._run(("call", self._ref(obj), name, self._enc(args), self._enc(kwargs)))

    def stream(self, obj, name: str, args: tuple, kwargs: dict):
        """The generator ``obj.name(*args, **kwargs)`` on every rank, driven
        by rank 0's consumer: each item is one operation; an abandoned
        stream closes on every rank."""
        with self._lock:
            self._begin()
            sid = self._new_id()
            self._run(("open", sid, self._ref(obj), name, self._enc(args), self._enc(kwargs)))
        done = False
        try:
            while True:
                with self._lock:
                    self._begin()
                    kind, item = self._run(("next", sid))
                if kind == "end":
                    done = True
                    return
                yield item
        except BaseException:
            done = done or self.broken is not None
            raise
        finally:
            if not done:
                self._close_stream(sid)

    def register(self, obj, kind: str, kwargs: dict) -> None:
        """Make the followers build their own ``kind`` object (the
        ``ContinuousBatcher`` of their pool) with ``kwargs``, keyed as
        ``obj``."""
        with self._lock:
            self._begin()
            oid = self._new_id()
            self._objects[oid] = obj
            obj._ctl_id = oid
            self._run(("new", oid, kind, self._enc(kwargs)))

    def stop(self) -> None:
        """End the followers' loops (rank 0; once)."""
        if not self.leader or self._stopped.is_set():
            return
        with self._lock:
            self._stopped.set()
            if self.broken is None:
                self._bcast(("stop",))

    def _close_stream(self, sid: int) -> None:
        # a stream closed inside another operation of this thread (a
        # finalizer) closes at the next operation, never nested
        if getattr(self._local, "depth", 0):
            self._pending_closes.append(sid)
            return
        with self._lock:
            if self.broken is None and not self._stopped.is_set():
                self._pending_closes.append(sid)
                self._begin()

    def _begin(self) -> None:
        """Checks before an operation; sends the closes pending."""
        if self.broken is not None:
            raise ReplicaDiverged(f"the tp ranks diverged earlier: {self.broken}")
        if self._stopped.is_set():
            raise RuntimeError("the tp controller is stopped")
        while self._pending_closes:
            self._run(("close", self._pending_closes.pop(0)))

    def _new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def _heartbeat(self) -> None:
        interval = self.timeout_s / 4
        while not self._stopped.wait(interval / 4):
            if time.monotonic() - self._last_op < interval:
                continue
            with self._lock:
                if self.broken is not None or self._stopped.is_set():
                    return
                try:
                    self._begin()
                    self._run(("noop",))
                except Exception as e:  # reported by the next call
                    print(f"[controller] heartbeat failed: {type(e).__name__}: {e}",
                          file=sys.stderr, flush=True)
                    return

    # -- every rank --
    def follow(self) -> None:
        """A follower's loop: apply rank 0's operations until it stops.
        Raises :class:`ReplicaDiverged` where the ranks disagree, and a
        collective's error where rank 0 is gone."""
        if self.leader:
            raise RuntimeError("rank 0 leads; followers follow")
        while True:
            op = self._recv()
            if op[0] == "stop":
                return
            try:
                self._run(op, send=False)
            except ReplicaDiverged:
                raise
            except Exception:
                pass  # every rank raised it: rank 0's caller hears of it

    def _bcast(self, op) -> None:
        dist.broadcast_object_list([op], src=0, group=self.group)
        self._last_op = time.monotonic()

    def _recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def _run(self, op, send: bool = True):
        """Broadcast ``op`` (rank 0), apply it here, agree on the outcome."""
        self._local.depth = getattr(self._local, "depth", 0) + 1
        try:
            if send:
                self._bcast(op)
            self.ops += 1
            try:
                result, error = self._apply(op), None
                status = "ok " + _digest(result)
            except Exception as e:
                result, error = None, e
                status = f"error {type(e).__name__}: {e}"
            statuses = [None] * self.size
            try:
                dist.all_gather_object(statuses, status, group=self.group)
            except Exception as e:  # a rank is gone, or stuck past the deadline
                self.broken = (f"operation {self.ops} {op[0]} {self._describe(op)}: rank "
                               f"{self.rank}: {status[:300]}; the outcomes could not be "
                               f"gathered: {e}")
                self._stopped.set()
                raise ReplicaDiverged(self.broken) from (error or e)
            if any(s != statuses[0] for s in statuses):
                self.broken = (f"operation {self.ops} {op[0]} {self._describe(op)}: "
                               + "; ".join(f"rank {r}: {s[:300]}" for r, s in enumerate(statuses)))
                self._stopped.set()
                raise ReplicaDiverged(self.broken) from error
            if error is not None:
                raise error
            return result
        finally:
            self._local.depth -= 1

    @staticmethod
    def _describe(op) -> str:
        if op[0] == "call":
            return f"{op[1].key}.{op[2]}"
        if op[0] == "open":
            return f"{op[2].key}.{op[3]}"
        return str(op[1:2])

    def _apply(self, op):
        kind = op[0]
        if kind == "call":
            _, ref, name, args, kwargs = op
            return getattr(self._deref(ref), name)(*self._dec(args), **self._dec(kwargs))
        if kind == "open":
            _, sid, ref, name, args, kwargs = op
            self._streams[sid] = getattr(self._deref(ref), name)(*self._dec(args),
                                                                 **self._dec(kwargs))
            return None
        if kind == "next":
            gen = self._streams[op[1]]
            try:
                return "item", next(gen)
            except StopIteration:
                del self._streams[op[1]]
                return "end", None
            except BaseException:
                del self._streams[op[1]]
                raise
        if kind == "close":
            gen = self._streams.pop(op[1], None)
            if gen is not None:
                gen.close()
            return None
        if kind == "new":
            _, oid, what, kwargs = op
            if oid not in self._objects:  # rank 0 registered its own
                from ..engine.sessions import ContinuousBatcher

                if what != "ContinuousBatcher":
                    raise ValueError(f"unknown replicated object {what!r}")
                obj = ContinuousBatcher(self.pool, **self._dec(kwargs))
                obj._ctl_id = oid
                self._objects[oid] = obj
            return None
        if kind == "noop":
            return None
        raise ValueError(f"unknown controller operation {kind!r}")

    # -- names on the wire --
    def _ref(self, obj) -> _Ref:
        from ..engine.sessions import ChatSession

        if obj is self.pool:
            return _Ref("pool")
        if isinstance(obj, ChatSession):
            return _Ref("session", obj.session_id)
        oid = getattr(obj, "_ctl_id", None)
        if oid is None:
            raise TypeError(f"{type(obj).__name__} is not replicated over the tp ranks")
        return _Ref("obj", oid)

    def _deref(self, ref: _Ref):
        kind = ref.key[0]
        if kind == "pool":
            return self.pool
        if kind == "session":
            s = self.pool._sessions.get(ref.key[1])
            if s is None:
                raise KeyError(f"no session {ref.key[1]} on rank {self.rank}")
            return s
        return self._objects[ref.key[1]]

    def _enc(self, x):
        from ..engine.sessions import ChatSession

        if isinstance(x, ChatSession):
            return self._ref(x)
        if isinstance(x, (list, tuple)):
            return type(x)(self._enc(v) for v in x)
        if isinstance(x, dict):
            return {k: self._enc(v) for k, v in x.items()}
        return x

    def _dec(self, x):
        if isinstance(x, _Ref):
            return self._deref(x)
        if isinstance(x, (list, tuple)):
            return type(x)(self._dec(v) for v in x)
        if isinstance(x, dict):
            return {k: self._dec(v) for k, v in x.items()}
        return x


def replicated(fn):
    """A device-touching method: on rank 0 of a controlled pool, run it on
    every rank as one operation (:meth:`Controller.call`); else call it."""

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        ctl = self._ctl
        if ctl is None or not ctl.leading():
            return fn(self, *args, **kwargs)
        return ctl.call(self, fn.__name__, args, kwargs)

    return call


def replicated_stream(fn):
    """:func:`replicated` for a generator method (:meth:`Controller.stream`)."""

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        ctl = self._ctl
        if ctl is None or not ctl.leading():
            return fn(self, *args, **kwargs)
        return ctl.stream(self, fn.__name__, args, kwargs)

    return call
