"""Futurization: ``dataflow`` and explicit task graphs (HPX P1).

The paper: *"Using Futurization, developers can express complex data flow
execution trees that generate millions of HPX tasks that by definition
execute in the proper order."*

``dataflow(fn, *args)`` schedules ``fn`` when every Future among its
(arbitrarily nested) arguments is ready; the call itself never blocks.
Sequential code is *futurized* by replacing values with futures — the
dependency DAG then schedules itself.

``TaskGraph`` is the explicit-DAG convenience used by the tiled-Cholesky
example/benchmark (the paper's "Linear Algebra Building Blocks"): nodes are
tasks, edges are futures, and the graph executes with exactly the
constraint-based (non-global-barrier) synchronization the paper advocates.

PyTorch note: when ``fn`` enqueues CUDA kernels, the *host* task completes
as soon as the launches return — the device runs on asynchronously and
downstream device work is ordered by the stream it is enqueued on.  Host
and device dependency graphs compose transparently, which is the paper's
"overlapping communication and computation" pattern on a GPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import scheduler as _sched
from repro_torch.core.future import Future, Promise, unwrap, when_all


def _collect_futures(obj: Any, out: List[Future]) -> None:
    if isinstance(obj, Future):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect_futures(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _collect_futures(v, out)


def dataflow(fn: Callable[..., Any], *args: Any, priority: Optional[int] = None,
             executor: Optional[Any] = None, **kwargs: Any) -> Future[Any]:
    """Schedule ``fn(*args)`` once all Future arguments are ready.

    Future arguments are replaced by their values (``unwrap``), including
    inside nested containers — HPX ``hpx::dataflow`` semantics.  With
    ``executor`` the fire task runs on that executor (e.g. a named pool of
    the resource partitioner) instead of the default pool; ``priority``
    composes with it (the executor is wrapped in a ``PriorityExecutor``).
    """
    if executor is not None and priority is not None:
        from repro_torch.core.executor import PriorityExecutor  # deferred: no cycle

        executor = PriorityExecutor(executor, priority)
    deps: List[Future] = []
    _collect_futures(args, deps)
    _collect_futures(kwargs, deps)
    promise: Promise[Any] = Promise()

    def _fire(_ready) -> None:
        def _run() -> None:
            try:
                promise.set_value(fn(*unwrap(list(args)), **unwrap(kwargs)))
            except BaseException as e:  # noqa: BLE001
                promise.set_exception(e)

        if executor is not None:
            executor.post(_run)
            return
        rt = _sched.current_runtime()
        if rt is not None:
            rt.spawn_raw(_run, priority=priority)
        else:
            _run()

    when_all(deps)._on_ready(_fire)
    return promise.future()


def futurize(fn: Callable[..., Any]) -> Callable[..., Future[Any]]:
    """Decorator: calls become dataflow tasks returning futures.

    >>> @futurize
    ... def add(a, b): return a + b
    >>> add(add(1, 2), 3).get()
    6
    """

    def wrapper(*args: Any, **kwargs: Any) -> Future[Any]:
        return dataflow(fn, *args, **kwargs)

    wrapper.__name__ = getattr(fn, "__name__", "futurized")
    wrapper.__wrapped__ = fn  # type: ignore[attr-defined]
    return wrapper


class TaskGraph:
    """Explicit dataflow DAG with named nodes.

    >>> g = TaskGraph()
    >>> a = g.add("a", lambda: 1)
    >>> b = g.add("b", lambda x: x + 1, deps=["a"])
    >>> g.run()["b"].get()
    2
    """

    def __init__(self) -> None:
        self._nodes: Dict[str, Tuple[Callable, List[str]]] = {}
        self._order: List[str] = []

    def add(self, name: str, fn: Callable[..., Any], deps: Sequence[str] = ()) -> str:
        if name in self._nodes:
            raise ValueError(f"duplicate task graph node {name!r}")
        for d in deps:
            if d not in self._nodes:
                raise ValueError(f"dependency {d!r} of {name!r} not yet defined")
        self._nodes[name] = (fn, list(deps))
        self._order.append(name)
        return name

    def run(self) -> Dict[str, Future[Any]]:
        """Launch every node as a dataflow task; returns name → Future."""
        futures: Dict[str, Future[Any]] = {}
        for name in self._order:  # insertion order is a topological order
            fn, deps = self._nodes[name]
            futures[name] = dataflow(fn, *[futures[d] for d in deps])
        return futures

    def __len__(self) -> int:
        return len(self._nodes)
