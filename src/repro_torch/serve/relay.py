"""Cross-locality token streaming + completion relay for the fleet tier,
ported from the reference's ``serve/relay.py``.

The in-process engine streams tokens through a :class:`~repro_torch.core.future.
Channel`; channels cannot cross a process boundary.  This module is the
wire form of that contract: the *engine side* holds a :class:`TokenRelay`
— a picklable Channel-alike whose ``set(tok)`` ships an indexed,
fire-and-forget token parcel to the client locality — and the *client
side* keeps a **sink registry** that reassembles each stream in order and
completes the caller's future from an authoritative done-parcel.

Why indices instead of trusting the wire: live engine migration
(`repro_torch.fleet.migrate`) moves a running engine — and its in-flight
streams — to another locality mid-generation.  The destination rebuilds
each request's relay at ``idx = len(generated)``, so the token sequence
the client sees is source ``0..k-1`` then destination ``k..n``.  Per-sid
index dedup makes delivery *exactly-once per index* no matter how parcels
interleave across the cutover (duplicates dropped, out-of-order buffered,
anything a crash swallowed backfilled from the done-parcel's full token
list) — the "zero dropped, zero duplicated tokens" guarantee is enforced
here and *counted* here::

    /serve{relay}/tokens/delivered      cumulative (in-order into channels)
    /serve{relay}/tokens/duplicates     cumulative (index seen twice: dropped)
    /serve{relay}/tokens/out_of_order   cumulative (buffered, then drained)
    /serve{relay}/tokens/backfilled     cumulative (recovered from done list)
    /serve{relay}/tokens/orphaned       cumulative (sid already gone)
    /serve{relay}/streams/{opened,closed,aborted}

Engine death is observed through :meth:`NetRuntime.add_peer_down_hook`:
every sink pinned to the dead locality aborts — with
:class:`StreamBroken` when tokens already flowed (not retriable: a
replacement engine would regenerate indices the client consumed), with
the raw failure when none did (the router may re-dispatch into the same
still-open channel).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import counters as _counters
from repro_torch.core import parcel as _parcel
from repro_torch.core.future import Channel, Future

__all__ = ["TokenRelay", "StreamBroken", "open_sink", "abort",
           "abort_for_peer", "rehome_streams", "attach_done", "reattach_for"]


class StreamBroken(RuntimeError):
    """A stream failed *after* delivering tokens: the prefix the consumer
    read is valid, the tail is gone, and a retry would duplicate it."""


def _reg():
    return _counters.default()


class _RelayCounters:
    _instance: Optional["_RelayCounters"] = None

    def __init__(self) -> None:
        reg = _reg()
        self.delivered = reg.counter("/serve{relay}/tokens/delivered")
        self.duplicates = reg.counter("/serve{relay}/tokens/duplicates")
        self.out_of_order = reg.counter("/serve{relay}/tokens/out_of_order")
        self.backfilled = reg.counter("/serve{relay}/tokens/backfilled")
        self.orphaned = reg.counter("/serve{relay}/tokens/orphaned")
        self.opened = reg.counter("/serve{relay}/streams/opened")
        self.closed = reg.counter("/serve{relay}/streams/closed")
        self.aborted = reg.counter("/serve{relay}/streams/aborted")

    @classmethod
    def get(cls) -> "_RelayCounters":
        # counters are get-or-create by name, so a lost race is harmless
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


# ---------------------------------------------------------------- engine side
class TokenRelay:
    """Engine-side stream endpoint: quacks like the Channel the engine
    already knows (``set`` / ``close``), ships indexed token parcels.

    ``idx`` is the next global token index of the request — a migrated
    request's rebuilt relay starts at ``len(generated)``, continuing the
    numbering the source locality left off at.  ``close`` is a no-op:
    stream end rides the done-parcel (:func:`attach_done`), which carries
    the authoritative full token list for backfill.
    """

    __slots__ = ("client", "sid", "idx", "stream")

    def __init__(self, client: int, sid: int, idx: int, stream: bool):
        self.client = client
        self.sid = sid
        self.idx = idx
        self.stream = stream

    def set(self, tok: int) -> None:
        idx, self.idx = self.idx, self.idx + 1
        if not self.stream:
            return  # non-streaming caller: the done-parcel carries it all
        from repro_torch.net import locality as _locality

        net = _locality.current()
        if net is None:
            return
        try:
            net.send_parcel(self.client, _DELIVER_TOKEN_NAME, None,
                            (self.sid, idx, int(tok)), want_result=False)
        except Exception:  # noqa: BLE001 — client gone; done/abort settles it
            pass

    def close(self, exc: Optional[BaseException] = None) -> None:
        pass


# ---------------------------------------------------------------- client side
class _Sink:
    __slots__ = ("channel", "locality", "next_idx", "pending", "delivered",
                 "on_result", "finalized", "lock")

    def __init__(self, channel: Optional[Channel], locality: int,
                 on_result: Callable[[bool, Any, Optional[Dict]], None]):
        self.channel = channel
        self.locality = locality  # where the engine currently lives
        self.next_idx = 0
        self.pending: Dict[int, int] = {}  # out-of-order buffer: idx → tok
        self.delivered = 0
        self.on_result = on_result
        self.finalized = False
        # per-sink lock: token parcels execute concurrently on the io pool,
        # and in-channel order must match index order
        self.lock = threading.Lock()


_sinks: Dict[int, _Sink] = {}
_sinks_lock = threading.Lock()
_sid_counter = itertools.count(1)


def _ensure_peer_hook(net) -> None:
    if getattr(net, "_relay_hooked", False):
        return
    net._relay_hooked = True
    net.add_peer_down_hook(abort_for_peer)


def open_sink(net, channel: Optional[Channel], locality: int,
              on_result: Callable[[bool, Any, Optional[Dict]], None]) -> int:
    """Register a stream sink; returns the sid the engine-side relay will
    address.  ``on_result(ok, payload_or_exc, gossip)`` fires exactly once
    — from the done-parcel, or from :func:`abort` when the engine's
    locality dies first."""
    _ensure_peer_hook(net)
    sid = next(_sid_counter)
    with _sinks_lock:
        _sinks[sid] = _Sink(channel, locality, on_result)
    _RelayCounters.get().opened.increment()
    return sid


def _push(sink: _Sink, tok: int, c: _RelayCounters) -> None:
    sink.next_idx += 1
    sink.delivered += 1
    c.delivered.increment()
    if sink.channel is not None:
        try:
            sink.channel.set(tok)
        except Exception:  # noqa: BLE001 — consumer closed its end early
            pass


@_parcel.action
def _deliver_token(rt, sid: int, idx: int, tok: int) -> None:
    """Client-side landing of one streamed token (fire-and-forget parcel).
    Exactly-once per index: duplicates drop, gaps buffer until filled, and
    anything racing the done-parcel (io-pool execution can reorder
    same-channel frames) counts orphaned, never double-delivers."""
    c = _RelayCounters.get()
    with _sinks_lock:
        sink = _sinks.get(sid)
    if sink is None:
        c.orphaned.increment()
        return
    with sink.lock:
        if sink.finalized:
            c.orphaned.increment()  # done/abort won the race; it backfilled
            return
        if idx < sink.next_idx or idx in sink.pending:
            c.duplicates.increment()
            return
        if idx > sink.next_idx:
            sink.pending[idx] = tok
            c.out_of_order.increment()
            return
        _push(sink, tok, c)
        while sink.next_idx in sink.pending:  # drain contiguous run
            _push(sink, sink.pending.pop(sink.next_idx), c)


@_parcel.action
def _deliver_done(rt, sid: int, ok: bool, payload: Any,
                  gossip: Optional[Dict[str, float]]) -> None:
    """Client-side landing of a request's completion.  On success
    ``payload`` is the authoritative full token list: any index the stream
    never delivered (parcel lost to a crash, or still stuck in the io
    pool) is backfilled from it *in order* before the channel closes — the
    consumer cannot tell the difference."""
    c = _RelayCounters.get()
    with _sinks_lock:
        sink = _sinks.pop(sid, None)
    if sink is None:
        return  # aborted already (peer death raced the done-parcel)
    with sink.lock:
        sink.finalized = True
        if ok:
            if sink.channel is not None:
                tokens: List[int] = payload
                for idx in range(sink.next_idx, len(tokens)):
                    was = sink.pending.pop(idx, None)
                    if was is None:
                        c.backfilled.increment()
                    _push(sink, tokens[idx], c)
                sink.channel.close()
            c.closed.increment()
            result = (True, payload, gossip)
        else:
            exc = payload
            if sink.delivered > 0:
                exc = StreamBroken(
                    f"stream {sid} failed after {sink.delivered} tokens: "
                    f"{payload!r}")
                if sink.channel is not None:
                    sink.channel.close(exc)
            c.aborted.increment()
            result = (False, exc, gossip)
    sink.on_result(*result)  # outside the lock: completes user promises


_DELIVER_TOKEN_NAME = _deliver_token._action_name
_DELIVER_DONE_NAME = _deliver_done._action_name


def abort(sid: int, exc: BaseException) -> int:
    """Fail one sink (idempotent).  Returns how many tokens it had already
    delivered.  With zero delivered the channel is left *open* — the
    router may re-dispatch the request into it; with any delivered the
    channel closes with :class:`StreamBroken` (retry would duplicate)."""
    with _sinks_lock:
        sink = _sinks.pop(sid, None)
    if sink is None:
        return 0
    with sink.lock:
        sink.finalized = True
        delivered = sink.delivered
        if delivered > 0:
            exc = StreamBroken(
                f"stream {sid} broke after {delivered} tokens: {exc!r}")
            if sink.channel is not None:
                sink.channel.close(exc)
    _RelayCounters.get().aborted.increment()
    sink.on_result(False, exc, None)
    return delivered


def abort_for_peer(lid: int) -> int:
    """Peer-down hook: abort every sink whose engine lived on ``lid``."""
    from repro_torch.net import parcelport as _pp

    with _sinks_lock:
        doomed = [sid for sid, s in _sinks.items() if s.locality == lid]
    n = 0
    for sid in doomed:
        abort(sid, _pp.PortClosed(f"engine locality#{lid} went away"))
        n += 1
    return n


def rehome_streams(old: int, new: int) -> int:
    """Re-pin every sink from locality ``old`` to ``new`` (live migration:
    must happen before the source locality can be retired, or the
    peer-down hook would abort streams the destination is still feeding)."""
    n = 0
    with _sinks_lock:
        for sink in _sinks.values():
            if sink.locality == old:
                sink.locality = new
                n += 1
    return n


def live_sids() -> List[int]:
    with _sinks_lock:
        return list(_sinks)


# ------------------------------------------------------------- engine hooks
def attach_done(engine, fut: Future, client: int, sid: int,
                tag: Optional[str] = None) -> None:
    """Wire a request future (at the engine's locality) to the client's
    sink: completion ships a done-parcel carrying the outcome plus this
    engine's load/occupancy gossip.  Re-attachable — migration calls this
    again at the destination; the source's pending future died with its
    process, so the sink still sees exactly one done-parcel."""
    def done(f: Future) -> None:
        from repro_torch.net import locality as _locality
        from repro_torch.obs import trace as _trace

        net = _locality.current()
        if net is None:
            return
        exc = f.exception()
        try:
            gossip = {"load": float(engine.load()),
                      "occ": float(engine.occupancy())}
        except Exception:  # noqa: BLE001
            gossip = None
        args = ((sid, True, f._value, gossip) if exc is None
                else (sid, False, exc, gossip))
        try:
            if _trace._enabled and tag:
                # tagged wrapper: the nested send:_deliver_done span's
                # parent is this sid, so the analyzer can attribute the
                # completion leg's wire time to the request
                with _trace.span("relay/done", "serve", req=tag, dst=client):
                    net.send_parcel(client, _DELIVER_DONE_NAME, None, args,
                                    want_result=False)
            else:
                net.send_parcel(client, _DELIVER_DONE_NAME, None, args,
                                want_result=False)
        except Exception:  # noqa: BLE001 — client gone; nothing to tell
            pass

    fut.on_ready(done)


@_parcel.action
def _fleet_submit(engine, prompt: List[int], max_new: Optional[int],
                  sampling, client: int, sid: int, want_stream: bool,
                  tag: Optional[str] = None,
                  slo: Optional[str] = None) -> bool:
    """Non-blocking engine submit (object-targeted, so live migration's
    UnknownGid self-heal re-routes it): builds the request's relay + meta,
    attaches the done hook, acks immediately.  Tokens and completion flow
    back as separate one-sided parcels — no pool worker blocks per
    request, which is what lets one locality hold hundreds of in-flight
    remote requests."""
    tag = tag or f"s{int(client)}:{int(sid)}"
    meta = {"client": int(client), "sid": int(sid),
            "stream": bool(want_stream), "req": tag, "slo": slo}
    relay = TokenRelay(int(client), int(sid), 0, bool(want_stream))
    fut = engine.submit(prompt, max_new, sampling, stream=relay, meta=meta)
    attach_done(engine, fut, int(client), int(sid), tag=tag)
    return True


def reattach_for(engine) -> Callable[[Any], None]:
    """The ``reattach`` callback :meth:`Engine.restore_requests` needs:
    rebuild each migrated request's relay continuing the source's token
    numbering, and re-wire its done hook to the same client sink."""
    def reattach(req) -> None:
        m = req.meta
        req.stream = TokenRelay(m["client"], m["sid"], len(req.generated),
                                m["stream"])
        attach_done(engine, req.promise.future(), m["client"], m["sid"],
                    tag=m.get("req"))

    return reattach
