"""Futures, promises and composition primitives (HPX P1).

HPX's central abstraction is the *future*: a proxy for a value that will be
computed asynchronously, enabling wait-free composition via ``.then()``,
``when_all`` / ``when_any`` and ``dataflow`` (see
:mod:`repro_torch.core.dataflow`).

PyTorch note: a CUDA tensor produced by enqueued kernels is *already* a
future — launches are asynchronous and the host only blocks when the value
is read.  ``repro_torch.core.Future`` is the host-plane complement: it
sequences *host* work (step dispatch, I/O, serving continuations) on the
AMT scheduler, while device work overlaps underneath.  ``Future.get`` on a
value holding CUDA tensors therefore composes both planes.

Deadlock-freedom: ``Future.get`` called *from a scheduler worker thread*
does not merely block — it runs a *help-along* loop, executing pending tasks
while it waits.  This mirrors HPX's user-level thread suspension (the paper's
"oversubscribing execution resources"): a blocked logical task never wastes
its execution resource.
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Any, Callable, Generic, Iterable, List, Optional, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class FutureState(Enum):
    PENDING = 0
    READY = 1
    FAILED = 2


class FutureError(RuntimeError):
    pass


class Future(Generic[T]):
    """Read side of a :class:`Promise`. One-shot, many readers."""

    __slots__ = ("_state", "_value", "_exc", "_cbs", "_cond")

    def __init__(self) -> None:
        self._state = FutureState.PENDING
        self._value: Optional[T] = None
        self._exc: Optional[BaseException] = None
        self._cbs: List[Callable[["Future[T]"], None]] = []
        self._cond = threading.Condition()

    # -- state ----------------------------------------------------------
    def is_ready(self) -> bool:
        with self._cond:
            return self._state is not FutureState.PENDING

    def has_value(self) -> bool:
        with self._cond:
            return self._state is FutureState.READY

    def has_exception(self) -> bool:
        with self._cond:
            return self._state is FutureState.FAILED

    # -- completion (used by Promise) ------------------------------------
    def _set(self, value: Optional[T], exc: Optional[BaseException]) -> None:
        with self._cond:
            if self._state is not FutureState.PENDING:
                raise FutureError("promise already satisfied")
            self._value = value
            self._exc = exc
            self._state = FutureState.FAILED if exc is not None else FutureState.READY
            cbs, self._cbs = self._cbs, []
            self._cond.notify_all()
        for cb in cbs:
            cb(self)

    # -- access -----------------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> T:
        """Wait for and return the value (re-raises a stored exception).

        From a worker thread this *helps along* — executes queued tasks while
        waiting, so nested blocking cannot starve the pool.
        """
        from repro_torch.core import scheduler as _sched  # deferred, avoids cycle

        rt = _sched.current_runtime()
        if rt is not None and rt.on_worker_thread():
            rt._help_until(self, timeout)  # executes tasks until ready
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._state is not FutureState.PENDING, timeout
            ):
                raise TimeoutError("future.get timed out")
            if self._exc is not None:
                raise self._exc
            return self._value  # type: ignore[return-value]

    def wait(self, timeout: Optional[float] = None) -> bool:
        from repro_torch.core import scheduler as _sched

        rt = _sched.current_runtime()
        if rt is not None and rt.on_worker_thread():
            rt._help_until(self, timeout)
        with self._cond:
            return self._cond.wait_for(
                lambda: self._state is not FutureState.PENDING, timeout
            )

    def wait_passive(self, timeout: Optional[float] = None) -> bool:
        """Plain blocking wait, never helps along (used *by* the help loop)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._state is not FutureState.PENDING, timeout
            )

    def exception(self) -> Optional[BaseException]:
        with self._cond:
            return self._exc

    # -- composition ------------------------------------------------------
    def _on_ready(self, cb: Callable[["Future[T]"], None]) -> None:
        """Run ``cb(self)`` when ready (immediately if already ready).

        The callback NEVER runs under the future's lock — neither from
        ``_set`` (completion) nor from the already-ready fast path here —
        so a callback may itself call ``get``/``then``/``on_ready`` on this
        future without deadlocking.  This is what makes the callback a safe
        remote-completion hook: the net layer forwards results over the
        parcelport from inside one."""
        run_now = False
        with self._cond:
            if self._state is FutureState.PENDING:
                self._cbs.append(cb)
            else:
                run_now = True
        if run_now:
            cb(self)

    def on_ready(self, cb: Callable[["Future[T]"], None]) -> None:
        """Public completion hook (value *or* exception): ``cb(self)`` runs
        exactly once, on the completing thread (or inline when already
        ready), outside the future's lock.  Unlike :meth:`then` it spawns
        no task — use it for cheap bookkeeping (counter updates, result
        forwarding); use ``then`` for real continuations."""
        self._on_ready(cb)

    def then(self, fn: Callable[["Future[T]"], U], priority: Optional[int] = None) -> "Future[U]":
        """HPX ``future::then`` — attach a continuation, get a new future.

        ``fn`` receives the *ready future* (HPX semantics, lets continuations
        inspect exceptions).  The continuation is a real task on the
        scheduler, so chains parallelize across workers.
        """
        from repro_torch.core import scheduler as _sched

        promise: Promise[U] = Promise()

        def _launch(ready: "Future[T]") -> None:
            def _run() -> None:
                try:
                    promise.set_value(fn(ready))
                except BaseException as e:  # noqa: BLE001 — futures carry any error
                    promise.set_exception(e)

            rt = _sched.current_runtime()
            if rt is not None:
                rt.spawn_raw(_run, priority=priority)
            else:  # no runtime: degrade to inline execution
                _run()

        self._on_ready(_launch)
        return promise.future()

    def then_value(self, fn: Callable[[T], U]) -> "Future[U]":
        """Convenience: continuation over the *value* (propagates errors)."""
        return self.then(lambda f: fn(f.get()))


class Promise(Generic[T]):
    """Write side: satisfied exactly once."""

    __slots__ = ("_future",)

    def __init__(self) -> None:
        self._future: Future[T] = Future()

    def future(self) -> Future[T]:
        return self._future

    def set_value(self, value: T) -> None:
        self._future._set(value, None)

    def set_exception(self, exc: BaseException) -> None:
        self._future._set(None, exc)

    def set_from(self, ready: "Future[T]") -> None:
        """Copy a *ready* future's outcome (value or exception) into this
        promise — the completion relay used when a result crosses a retry
        loop or the parcelport (remote completion)."""
        exc = ready.exception()
        if exc is not None:
            self._future._set(None, exc)
        else:
            self._future._set(ready._value, None)


class ChannelClosed(FutureError):
    """Raised by :meth:`Channel.get` once the channel is closed and drained."""


class Channel(Generic[T]):
    """HPX ``hpx::lcos::channel<T>`` — an ordered multi-value pipe.

    Producers :meth:`set` values; consumers :meth:`get` them FIFO (each
    ``get`` is backed by a :class:`Future`, so consumers on scheduler
    workers *help along* instead of blocking the pool).  :meth:`close`
    ends the stream: buffered values still drain, then ``get`` raises
    :class:`ChannelClosed` and iteration stops.  The serve engine streams
    one token per ``set`` and closes on request completion.
    """

    __slots__ = ("_buf", "_waiters", "_closed", "_close_exc", "_lock")

    def __init__(self) -> None:
        self._buf: List[T] = []
        self._waiters: List[Promise[T]] = []
        self._closed = False
        self._close_exc: Optional[BaseException] = None
        self._lock = threading.Lock()

    def set(self, value: T) -> None:
        """Push one value (wakes the oldest waiter, else buffers)."""
        with self._lock:
            if self._closed:
                raise ChannelClosed("set() on closed channel")
            waiter = self._waiters.pop(0) if self._waiters else None
            if waiter is None:
                self._buf.append(value)
        if waiter is not None:
            waiter.set_value(value)

    def _end_exc(self) -> BaseException:
        return self._close_exc or ChannelClosed("channel closed")

    def close(self, exc: Optional[BaseException] = None) -> None:
        """End the stream. Buffered values remain readable; blocked and
        future ``get``s observe :class:`ChannelClosed` — or ``exc``, when
        given: the error takes the FIFO position *after* everything already
        buffered, so a producer failing mid-stream delivers every token it
        produced and then the failure, in order.  Blocked readers (buffer
        necessarily empty) see it immediately.  A second close keeps the
        first outcome."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._close_exc = exc
            waiters, self._waiters = self._waiters, []
        end = self._end_exc()
        for w in waiters:
            w.set_exception(end)

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def get_future(self) -> Future[T]:
        """Future for the next value, HPX ``channel::get`` semantics."""
        promise: Promise[T] = Promise()
        with self._lock:
            if self._buf:
                value, ok = self._buf.pop(0), True
            elif self._closed:
                value, ok = None, False
            else:
                self._waiters.append(promise)
                return promise.future()
        if ok:
            promise.set_value(value)  # type: ignore[arg-type]
        else:
            promise.set_exception(self._end_exc())
        return promise.future()

    def get(self, timeout: Optional[float] = None) -> T:
        return self.get_future().get(timeout)

    def try_get(self):
        """Non-blocking: (True, value) or (False, None)."""
        with self._lock:
            if self._buf:
                return True, self._buf.pop(0)
            return False, None

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except ChannelClosed:
                return


def make_ready_future(value: T) -> Future[T]:
    p: Promise[T] = Promise()
    p.set_value(value)
    return p.future()


def make_exceptional_future(exc: BaseException) -> Future[Any]:
    p: Promise[Any] = Promise()
    p.set_exception(exc)
    return p.future()


def when_all(futures: Sequence[Future[Any]]) -> Future[List[Future[Any]]]:
    """Future that becomes ready when *all* inputs are ready.

    Like HPX, the result is the list of (ready) input futures — exceptions
    are observed by the consumer, not swallowed here.
    """
    futures = list(futures)
    promise: Promise[List[Future[Any]]] = Promise()
    if not futures:
        promise.set_value([])
        return promise.future()
    remaining = [len(futures)]
    lock = threading.Lock()

    def _one_done(_f: Future[Any]) -> None:
        with lock:
            remaining[0] -= 1
            done = remaining[0] == 0
        if done:
            promise.set_value(futures)

    for f in futures:
        f._on_ready(_one_done)
    return promise.future()


def when_any(futures: Sequence[Future[Any]]) -> Future[int]:
    """Future ready when *any* input is; value = index of the winner."""
    futures = list(futures)
    if not futures:
        raise ValueError("when_any of empty sequence")
    promise: Promise[int] = Promise()
    fired = threading.Event()

    def _make(i: int) -> Callable[[Future[Any]], None]:
        def _cb(_f: Future[Any]) -> None:
            if not fired.is_set():
                # benign race: Event + one-shot promise; double-set guarded
                try:
                    promise.set_value(i)
                    fired.set()
                except FutureError:
                    pass

        return _cb

    for i, f in enumerate(futures):
        f._on_ready(_make(i))
    return promise.future()


def wait_all(futures: Iterable[Future[Any]], timeout: Optional[float] = None) -> None:
    when_all(list(futures)).wait(timeout)


def unwrap(value: Any) -> Any:
    """Recursively resolve Futures inside (nested) lists/tuples/dicts."""
    if isinstance(value, Future):
        return unwrap(value.get())
    if isinstance(value, (list, tuple)):
        return type(value)(unwrap(v) for v in value)
    if isinstance(value, dict):
        return {k: unwrap(v) for k, v in value.items()}
    return value
