"""Parcels — one-sided active messages / RPC (HPX P4, paper §2.3).

A parcel ships *a function invocation* to where the data lives ("send work
to data, not data to work"); the destination never polls, and the result
comes back through a future.

An :class:`Action` is a registered, named function; ``apply(action,
target_gid, *args)`` resolves the target via AGAS and runs the action
*against the live object* on a scheduler task, returning a Future.  Since
the target object may be a tree of CUDA tensors, "executing where the data
lives" is real: the action body enqueues kernels on the tensors' own card,
and nothing is copied — the parcel carries a reference, never the bytes.

The device plane of the reference (``shard_parcel``: an action body run
per shard of a device mesh, with collectives as its transport) waits for
the port's mesh.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import scheduler as _sched
from repro_torch.core.future import Future


class ActionRegistry:
    """Named action table (HPX: ``HPX_REGISTER_ACTION``).

    Resolution is *lazy across processes*: a worker locality receiving a
    parcel for an action it has never imported resolves the dotted default
    name (``module.qualname``) by importing the module — the action-table
    analogue of HPX's registration macros running at static-init time in
    every locality's binary.
    """

    def __init__(self) -> None:
        self._actions: Dict[str, Callable[..., Any]] = {}
        self._lock = threading.Lock()

    def register(self, fn: Callable[..., Any], name: Optional[str] = None) -> str:
        name = name or f"{fn.__module__}.{fn.__qualname__}"
        with self._lock:
            if name in self._actions and self._actions[name] is not fn:
                raise KeyError(f"action name already registered: {name!r}")
            self._actions[name] = fn
        return name

    def resolve(self, name: str) -> Callable[..., Any]:
        with self._lock:
            fn = self._actions.get(name)
        if fn is not None:
            return fn
        self._import_defining_module(name)
        with self._lock:
            fn = self._actions.get(name)
        if fn is not None:
            return fn
        # plain module-level function (registered ad hoc at the sender, so
        # no decorator ran here): walk module attributes by qualname
        fn = self._locate_by_qualname(name)
        if fn is not None:
            self.register(fn, name)
            return fn
        raise KeyError(f"unknown action: {name!r}")

    def _locate_by_qualname(self, name: str) -> Optional[Callable[..., Any]]:
        import sys

        parts = name.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = sys.modules.get(".".join(parts[:cut]))
            if mod is None:
                continue
            obj: Any = mod
            try:
                for attr in parts[cut:]:
                    obj = getattr(obj, attr)
            except AttributeError:
                continue
            if callable(obj):
                return obj
        return None

    def _import_defining_module(self, name: str) -> None:
        """Import the longest module prefix of ``module.qualname`` so the
        ``@action`` decorators at its top level run and self-register."""
        import importlib

        parts = name.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            modname = ".".join(parts[:cut])
            try:
                importlib.import_module(modname)
                return
            except ModuleNotFoundError as e:
                missing_is_target = e.name and (
                    modname == e.name or modname.startswith(e.name + "."))
                if not missing_is_target:
                    raise  # a real dependency failure inside the module
                continue  # qualname segment, not a module — try shorter

    def names(self):
        with self._lock:
            return sorted(self._actions)


_registry = ActionRegistry()


def action(fn: Callable[..., Any] = None, *, name: Optional[str] = None):
    """Decorator registering an action; the wrapper keeps the plain call.

    >>> @action
    ... def scale(obj, s): return obj * s
    """

    def deco(f: Callable[..., Any]) -> Callable[..., Any]:
        f._action_name = _registry.register(f, name)  # type: ignore[attr-defined]
        return f

    return deco(fn) if fn is not None else deco


@dataclass
class Parcel:
    """destination GID + action + arguments (+ continuation promise)."""

    action_name: str
    target: Any  # GID or symbolic name
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)


class ParcelPort:
    """Local parcel port: decodes parcels and spawns the action as a task.

    In HPX the parcelport moves bytes between nodes; in one process every
    device is addressable from the host, so the "network" hop is the device
    placement of the target object — the action body's kernels run on the
    target's device.  The port still gives
    us HPX semantics: one-sided, asynchronous, future-returning, counted.
    """

    def __init__(self, name: str = "port#0", resolver: Optional[_agas.AGAS] = None):
        self.name = name
        self.resolver = resolver or _agas.default()
        reg = _counters.default()
        self.c_sent = reg.counter(f"/parcel{{{name}}}/count/sent")
        self.c_actions = reg.counter(f"/parcel{{{name}}}/actions/executed")

    def send(self, parcel: Parcel) -> Future[Any]:
        """Deliver a parcel: resolve target, run action where the data is.

        With a multi-locality runtime up (:mod:`repro_torch.net`), a
        parcel whose target does not resolve locally is handed to the
        installed remote route — the transport resolves the owning locality through the
        distributed AGAS tier and ships the invocation over the parcelport.
        """
        self.c_sent.increment()
        resolver = self.resolver
        route = _remote_route
        if route is not None and not resolver.contains(parcel.target):
            remote_future = route(parcel)
            if remote_future is not None:
                return remote_future

        def _deliver() -> Any:
            rec = resolver.record(parcel.target)
            fn = _registry.resolve(parcel.action_name)
            self.c_actions.increment()
            return fn(rec.obj, *parcel.args, **parcel.kwargs)

        return _sched.get_runtime().spawn(_deliver)

    def apply(self, fn: Callable[..., Any], target, *args: Any, **kwargs: Any) -> Future[Any]:
        """``hpx::async(action, gid, args...)`` convenience."""
        name = getattr(fn, "_action_name", None) or _registry.register(fn)
        return self.send(Parcel(name, target, args, kwargs))


_port: Optional[ParcelPort] = None
_port_lock = threading.Lock()

# Remote transport hook, installed by the multi-locality runtime when
# localities are real processes: fn(parcel) -> Future | None (None = "target
# is local after all").
_remote_route = None


def set_remote_route(fn) -> None:
    """Install/uninstall (``None``) the cross-locality delivery path."""
    global _remote_route
    _remote_route = fn


def default_port() -> ParcelPort:
    global _port
    with _port_lock:
        if _port is None:
            _port = ParcelPort()
        return _port


def apply(fn: Callable[..., Any], target, *args: Any, **kwargs: Any) -> Future[Any]:
    """Module-level one-sided invoke: run ``fn(object_at(target), *args)``."""
    return default_port().apply(fn, target, *args, **kwargs)
