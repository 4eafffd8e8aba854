"""Parcelport — the tiered byte-moving layer of the multi-locality runtime,
ported from the reference's ``net/parcelport.py``: the same frames, lanes,
tiers and counters, so a payload that holds no tensor encodes to the
reference's bytes.  Only the host walk differs (:func:`_to_host`): torch
tensors, not ``jax.Array``, become host numpy buffers before pickling.

HPX's parcelport is the pluggable transport that ships serialized parcels
between localities; the HPX+LCI study (Yan et al., PAPERS.md) identifies
what AMT traffic needs from this layer — small-message aggregation,
protocol separation by payload size, dedicated progress resources, and
explicit flow control.  This module implements all four over stream
sockets between OS processes on one host:

- **eager protocol** (payloads under ``NetConfig.eager_threshold``) —
  the whole frame ships inline on the peer's *priority lane* and is
  **coalesced**: sub-threshold frames queued while the short adaptive
  window is open are packed into one multi-parcel container frame,
  flushed by size, parcel count, or deadline.  The first frame after a
  quiet period always goes out immediately, so coalescing adds no
  latency at low rates and amortizes syscalls at high rates.
- **rendezvous protocol** (large payloads) — a small RTS (request to
  send) control frame travels the priority lane; the receiver allocates
  an assembly buffer and grants a CTS; the sender then **stripes** the
  body+buffer byte stream across the N parallel *bulk lanes* in
  ``stripe_chunk``-sized DATA frames.  Bulk bytes never touch the
  priority lane, so one big ``fetch``/``migrate_remote`` cannot
  head-of-line-block latency-sensitive parcels.  The receiver bounds
  concurrent assemblies per sender (``max_rendezvous``) — rendezvous is
  its own flow control.
- **explicit backpressure** (eager parcels) — a per-destination ledger
  of parcel bytes in flight, replenished by CREDIT frames the receiver
  returns *after executing* each parcel.  Once ``send_budget`` is
  exhausted, producer threads block in ``send`` (never the scheduler
  pools or the progress thread, which defer to a FIFO instead), so a
  flooded peer degrades its senders instead of growing queues without
  bound.
- **one progress thread per port** — every socket is non-blocking and
  multiplexed through one readiness loop (``selectors``) per
  :class:`Port`, replacing the previous 2-threads-per-connection pump
  design.  Producers attempt a lock-guarded direct write when a lane is
  idle (no wakeup latency on the common path); the progress thread
  finishes partial writes, runs the receive state machines, the
  coalesce timers, and the rendezvous handshakes.

Wire format (unchanged framing, new frame types)::

    frame := u32 total | u32 header_len | header | rest          (BE)

- ``parcel`` / ``result`` — rest is pickle-5 body + out-of-band buffers
  (the zero-copy path [Biddiscombe et al. 2017]: contiguous array bytes
  never enter the pickle stream on either side).  A tensor never goes
  through torch's own reducer, which would put CPU storage in band and
  rebuild a CUDA tensor on the receiver's card: it travels as numpy, and
  a bf16 tensor (numpy has no bf16) as its 16-bit pattern, rebuilt as a
  bf16 tensor on the receiver.
- ``multi``  — rest is a concatenation of complete sub-frames (each with
  its own u32 prefix); src/dst are uniform, so the root's frame switch
  forwards whole containers without unpacking them.
- ``rts`` / ``cts`` / ``data`` — the rendezvous handshake; a DATA frame's
  rest is a raw window of the payload stream (``o``/``n`` offsets), read
  on the receive side *directly into* the preallocated assembly buffer.
- ``credit`` — returns ``n`` budget bytes to the original sender
  (end-to-end: forwarded through the root for worker↔worker traffic).
- ``hello`` / ``bye`` / ``down`` — lifecycle: per-lane handshake,
  shutdown, and the root's peer-death broadcast.

Counters, per channel (HPX ``/parcelport{...}`` naming)::

    /net{locality#L/peer#P}/parcels/sent|received    logical messages
    /net{locality#L/peer#P}/frames/sent|received     wire frames
    /net{locality#L/peer#P}/bytes/sent|received      wire bytes
    /net{locality#L/peer#P}/coalesce/flushes         multi containers sent
    /net{locality#L/peer#P}/coalesce/parcels         frames packed into them
    /net{locality#L/peer#P}/rendezvous/sent|received completed transfers
    /net{locality#L/peer#P}/credit/blocked|deferred  backpressure events
    /net{locality#L/peer#P}/credit/inflight_bytes    gauge, unacked bytes
"""

from __future__ import annotations

import collections
import copyreg
import io
import os
import pickle
import selectors
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import counters as _counters
from repro_torch.obs import trace as _trace

try:  # msgpack headers when available (smaller + faster), pickle otherwise
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - container ships msgpack
    _msgpack = None

_U32 = struct.Struct(">I")

# Frame types
PARCEL = "parcel"
RESULT = "result"
HELLO = "hello"
BYE = "bye"
MULTI = "multi"     # coalesced container of complete sub-frames
RTS = "rts"         # rendezvous: request to send (carries the real header)
CTS = "cts"         # rendezvous: clear to send (assembly allocated)
DATA = "data"       # rendezvous: one striped window of the payload stream
CREDIT = "credit"   # flow control: return budget bytes to the sender
DOWN = "down"       # root broadcast: a peer locality died
TOPO = "topo"       # root broadcast: the locality id space grew (elastic)

_NO_PAYLOAD = object()

# Frames the root's switch forwards by dst; HELLO/BYE/DOWN are hop-local.
_FORWARDABLE = frozenset((PARCEL, RESULT, MULTI, RTS, CTS, DATA, CREDIT))


class PortClosed(ConnectionError):
    """The peer went away (EOF / reset) or the port was closed locally."""


# ------------------------------------------------------------------- config
@dataclass(frozen=True)
class NetConfig:
    """Tuning knobs of the tiered transport (see README "NetConfig").

    Every field can be overridden through ``REPRO_NET_<FIELD>`` (upper
    case) environment variables, which also reach spawned worker
    localities (the root passes its resolved config to them verbatim).
    """

    eager_threshold: int = 64 * 1024    # payload bytes: eager vs rendezvous
    coalesce_max_bytes: int = 56 * 1024  # flush a container at this size
    coalesce_max_parcels: int = 128      # ... or at this many sub-frames
    coalesce_window_us: float = 300.0    # max added delay (adaptive upper)
    coalesce_min_window_us: float = 50.0
    stripes: int = 2                     # bulk lanes per peer (0 = share)
    stripe_chunk: int = 1 << 20          # bytes per DATA frame
    max_rendezvous: int = 4              # concurrent assemblies per sender
    send_budget: int = 1 << 20           # unacked eager parcel bytes / dst
    block_timeout: float = 120.0         # producer backpressure block cap

    @classmethod
    def from_env(cls) -> "NetConfig":
        kw: Dict[str, Any] = {}
        for name, f in cls.__dataclass_fields__.items():
            raw = os.environ.get(f"REPRO_NET_{name.upper()}")
            if raw is not None:
                kw[name] = (float(raw) if isinstance(f.default, float)
                            else int(float(raw)))
        return cls(**kw)


# ------------------------------------------------------------------- codec
def _encode_header(header: Dict[str, Any]) -> bytes:
    if _msgpack is not None:
        return _msgpack.packb(header, use_bin_type=True)
    return pickle.dumps(header, protocol=5)


def _decode_header(data: bytes) -> Dict[str, Any]:
    if _msgpack is not None:
        return _msgpack.unpackb(data, raw=False)
    return pickle.loads(data)


class _Bf16Bits:
    """A bf16 tensor on the wire: its 16-bit pattern as an int16 array,
    which pickles out of band; the receiver rebuilds a CPU bf16 tensor."""

    __slots__ = ("bits",)

    def __init__(self, bits: Any):
        self.bits = bits

    def __reduce__(self):
        return _bf16_from_bits, (self.bits,)


def _bf16_from_bits(bits: Any) -> Any:
    import numpy as np
    import torch

    if not bits.flags.aligned or not bits.flags.writeable:
        bits = np.array(bits)  # an out-of-band buffer at an odd offset
    return torch.from_numpy(bits).view(torch.bfloat16)


def _tensor_to_host(t: Any) -> Any:
    """One tensor leaf → what crosses the wire: a CUDA tensor takes one
    device-to-host copy; a contiguous CPU tensor becomes a zero-copy numpy
    view (out of band under pickle 5); bf16 travels as its bits."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bfloat16:
        return _Bf16Bits(t.view(torch.int16).numpy())
    return t.numpy()


def _to_host(obj: Any) -> Any:
    """Swap ``torch.Tensor`` leaves for host numpy views ahead of pickling.

    Only walks containers when torch is already imported — light processes
    never pay the import — and the walk is **identity-preserving**: when
    no tensor leaf is found, every container comes back ``is`` the
    original (nothing is rebuilt or deep-copied for tensor-free payloads).
    Tensors inside other objects are caught by the pickler's dispatch
    table (:func:`_encode_body`), never by torch's reducer.
    """
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return obj

    def walk(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return _tensor_to_host(x)
        if isinstance(x, tuple) and hasattr(x, "_fields"):  # NamedTuple
            new = [walk(v) for v in x]
            if all(a is b for a, b in zip(new, x)):
                return x
            return type(x)(*new)
        if isinstance(x, (list, tuple)):
            new = [walk(v) for v in x]
            if all(a is b for a, b in zip(new, x)):
                return x
            return type(x)(new)
        if isinstance(x, dict):
            new = {k: walk(v) for k, v in x.items()}
            if all(a is b for a, b in zip(new.values(), x.values())):
                return x
            return new
        return x

    return walk(obj)


def _reduce_tensor(t: Any):
    return _identity, (_tensor_to_host(t),)


def _identity(x: Any) -> Any:
    return x


def _dumps(obj: Any, buffer_callback) -> bytes:
    """``pickle.dumps`` at protocol 5; once torch is imported, a tensor the
    walk could not reach (inside another object) still crosses as host
    numpy through the dispatch table."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return pickle.dumps(obj, protocol=5, buffer_callback=buffer_callback)
    out = io.BytesIO()
    p = pickle.Pickler(out, protocol=5, buffer_callback=buffer_callback)
    p.dispatch_table = {**copyreg.dispatch_table,
                        torch.Tensor: _reduce_tensor,
                        torch.nn.Parameter: _reduce_tensor}
    p.dump(obj)
    return out.getvalue()


def _encode_body(payload: Any) -> Tuple[bytes, List[memoryview]]:
    """Pickle a payload with every contiguous array buffer out of band."""
    if payload is _NO_PAYLOAD:
        return b"", []
    buffers: List[pickle.PickleBuffer] = []
    body = _dumps(_to_host(payload), buffers.append)
    return body, [b.raw() for b in buffers]


def _assemble(header: Dict[str, Any], body: bytes,
              views: List[memoryview]) -> List[Any]:
    """Build the chunk list of one complete frame (prefix included).

    The head chunk is one ``b"".join`` pass over preallocated pieces —
    no ``io.BytesIO`` copies — and each buffer view rides zero-copy.
    """
    header = dict(header)
    header["blens"] = [v.nbytes for v in views]
    header["bodylen"] = len(body)
    hdr = _encode_header(header)
    total = 4 + len(hdr) + len(body) + sum(v.nbytes for v in views)
    prefix = bytearray(8)
    _U32.pack_into(prefix, 0, total)
    _U32.pack_into(prefix, 4, len(hdr))
    return [b"".join((prefix, hdr, body)), *views]


def encode_frame(header: Dict[str, Any], payload: Any = _NO_PAYLOAD) -> List[Any]:
    """Serialize one eager frame into a chunk list ready for vectored
    send: ``[prefix+header+body, buffer0, buffer1, ...]`` where each
    buffer is a zero-copy view of the original array memory."""
    body, views = _encode_body(payload)
    return _assemble(header, body, views)


def _chunks_nbytes(chunks: List[Any]) -> int:
    return sum(len(c) if isinstance(c, (bytes, bytearray)) else c.nbytes
               for c in chunks)


def decode_frame(frame: memoryview) -> Tuple[Dict[str, Any], memoryview]:
    """Split a received frame (sans the u32 total prefix) into
    ``(header, rest)`` where ``rest`` covers body+buffers."""
    hlen = _U32.unpack_from(frame, 0)[0]
    header = _decode_header(bytes(frame[4:4 + hlen]))
    return header, frame[4 + hlen:]


def frame_rest(frame: memoryview) -> memoryview:
    """Body+buffers view of a frame whose header was already decoded."""
    hlen = _U32.unpack_from(frame, 0)[0]
    return frame[4 + hlen:]


def forward_chunks(frame: memoryview) -> List[Any]:
    """Re-frame a received frame for forwarding: the payload bytes are
    never re-encoded, just re-prefixed."""
    return [_U32.pack(frame.nbytes), frame]


def reframe(hbytes: bytes, rest: memoryview) -> List[Any]:
    """Forwarding path: rebuild the wire chunks of a parsed frame without
    re-encoding header or payload."""
    total = 4 + len(hbytes) + rest.nbytes
    return [b"".join((_U32.pack(total), _U32.pack(len(hbytes)), hbytes)), rest]


def iter_multi(header: Dict[str, Any], rest: memoryview):
    """Walk a MULTI container's rest: yields ``(sub_header, sub_hbytes,
    sub_rest, sub_wire_bytes)`` per packed sub-frame."""
    p = 0
    for _ in range(header.get("n", 0)):
        sublen = _U32.unpack_from(rest, p)[0]
        sub = rest[p + 4:p + 4 + sublen]
        hlen = _U32.unpack_from(sub, 0)[0]
        hbytes = bytes(sub[4:4 + hlen])
        yield _decode_header(hbytes), hbytes, sub[4 + hlen:], 4 + sublen
        p += 4 + sublen


def failed_parcel_headers(fr: "Frame"):
    """Every parcel header carried by a frame that could not be forwarded
    (the frame itself, a rendezvous announcement's inner header, or each
    sub-frame of a coalesced container)."""
    h = fr.header
    t = h.get("t")
    if t == PARCEL:
        yield h
    elif t == RTS:
        inner = h.get("h") or {}
        if inner.get("t") == PARCEL:
            yield inner
    elif t == MULTI:
        for shdr, _hb, _rest, _wire in iter_multi(h, fr.rest):
            if shdr.get("t") == PARCEL:
                yield shdr


def decode_payload(header: Dict[str, Any], rest: memoryview) -> Any:
    """Unpickle the body against in-place buffer views (zero-copy)."""
    bodylen = header.get("bodylen", 0)
    if not bodylen:
        return None
    body = rest[:bodylen]
    bufs, off = [], bodylen
    for n in header.get("blens", ()):
        bufs.append(rest[off:off + n])
        off += n
    return pickle.loads(body, buffers=bufs)


def encode_result_payload(header: Dict[str, Any], value: Any,
                          exc: Optional[BaseException]) -> List[Any]:
    """Encode a result frame, degrading unpicklable values/exceptions to a
    picklable ``RuntimeError`` so the caller always gets *an* outcome."""
    header = dict(header)
    header["ok"] = exc is None
    payload = value if exc is None else exc
    try:
        return encode_frame(header, payload)
    except Exception as e:  # noqa: BLE001 — unpicklable result
        header["ok"] = False
        return encode_frame(header, RuntimeError(
            f"unpicklable {'result' if exc is None else 'exception'} "
            f"from action {header.get('a')!r}: {payload!r} ({e})"))


def _degrade_result(header: Dict[str, Any], payload: Any,
                    e: Exception) -> Tuple[Dict[str, Any], bytes, list]:
    kind = "result" if header.get("ok") else "exception"
    header = dict(header)
    header["ok"] = False
    body, views = _encode_body(RuntimeError(
        f"unpicklable {kind} from action {header.get('a')!r}: "
        f"{payload!r} ({e})"))
    return header, body, views


# ----------------------------------------------------- blocking-read helpers
def read_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise PortClosed("peer closed the connection")
        got += k
    return buf


def read_frame(sock: socket.socket) -> memoryview:
    """Blocking read of one length-prefixed frame (without the prefix) —
    used only for the bootstrap HELLO handshake, before a socket joins a
    port's readiness loop."""
    total = _U32.unpack(bytes(read_exact(sock, 4)))[0]
    return memoryview(read_exact(sock, total))


def _is_runtime_thread() -> bool:
    """True on scheduler pool workers and transport threads — the threads
    that must never block on backpressure (they are the drain)."""
    return threading.current_thread().name.startswith("repro-")


# ------------------------------------------------------------- wire structs
class Frame:
    """One parsed wire frame: decoded header + raw pieces for zero-copy
    forwarding (``hbytes``) and payload decode (``rest``)."""

    __slots__ = ("header", "hbytes", "rest", "wire_bytes", "credit_bytes")

    def __init__(self, header: Dict[str, Any], hbytes: bytes,
                 rest: memoryview, wire_bytes: int, credit_bytes: int):
        self.header = header
        self.hbytes = hbytes
        self.rest = rest
        self.wire_bytes = wire_bytes
        # bytes of send-budget this frame consumed at its sender; the
        # receiver returns exactly this as CREDIT after execution
        # (0 for rendezvous-assembled parcels — they never took credit)
        self.credit_bytes = credit_bytes


class _Ledger:
    """Per-destination eager-parcel flow control state (sender side)."""

    __slots__ = ("inflight", "deferred", "cv")

    def __init__(self, lock: threading.RLock):
        self.inflight = 0
        self.deferred: "collections.deque[Tuple[List[Any], int]]" = \
            collections.deque()
        self.cv = threading.Condition(lock)


class _Coalesce:
    """One open aggregation buffer (per destination locality)."""

    __slots__ = ("parts", "nbytes", "count", "deadline")

    def __init__(self, deadline: float):
        self.parts: List[List[Any]] = []
        self.nbytes = 0
        self.count = 0
        self.deadline = deadline


class _OutXfer:
    """Sender-side pending rendezvous: encoded stream parked until CTS."""

    __slots__ = ("xid", "dst", "stream", "size", "t0")

    def __init__(self, xid: int, dst: int, stream: List[memoryview],
                 size: int):
        self.xid = xid
        self.dst = dst
        self.stream = stream
        self.size = size
        self.t0 = 0.0  # RTS send time when tracing — the CTS-wait clock


class _InXfer:
    """Receiver-side assembly of one striped rendezvous transfer."""

    __slots__ = ("src", "xid", "header", "buf", "got", "size")

    def __init__(self, src: int, xid: int, header: Dict[str, Any],
                 size: int):
        self.src = src
        self.xid = xid
        self.header = header
        self.buf = bytearray(size)
        self.got = 0
        self.size = size


class _Lane:
    """One non-blocking socket of a channel: write queue + read machine."""

    __slots__ = ("sock", "idx", "channel", "wq", "wlock", "woff",
                 "want_write", "bytes_written", "bytes_read", "wstart",
                 "rscratch", "rlo", "rhi", "rphase", "rpre", "rpre_got",
                 "rhdr", "rhdr_got", "rheader", "rrest", "rrest_got",
                 "rrest_len", "rassembly", "rtotal")

    def __init__(self, sock: socket.socket, idx: int, channel: "Channel"):
        sock.setblocking(False)
        self.sock = sock
        self.idx = idx
        self.channel = channel
        self.wq: "collections.deque[List[Any]]" = collections.deque()
        self.wlock = threading.Lock()
        self.woff = 0            # byte offset into the head message
        self.want_write = False
        self.wstart = 0.0
        self.bytes_written = 0   # test-inspectable per-lane totals
        self.bytes_read = 0
        # read state machine
        self.rscratch = bytearray(1 << 17)
        self.rlo = self.rhi = 0
        self.rphase = 0          # 0 = prefix, 1 = header, 2 = rest
        self.rpre = bytearray(8)
        self.rpre_got = 0
        self.rhdr = b""
        self.rhdr_got = 0
        self.rheader: Optional[Dict[str, Any]] = None
        self.rrest: Optional[memoryview] = None
        self.rrest_got = 0
        self.rrest_len = 0
        self.rassembly: Optional[_InXfer] = None
        self.rtotal = 0


# --------------------------------------------------------------- the channel
class Channel:
    """All lanes to one peer: priority lane 0 + ``stripes`` bulk lanes.

    Holds the per-destination coalesce buffers and credit ledgers for
    every destination *routed through* this peer (a worker's single
    channel to the root carries traffic for all localities)."""

    def __init__(self, port: "Port", peer_id: int,
                 socks: List[socket.socket]):
        self.port = port
        self.peer_id = peer_id
        self.local_id = port.local_id
        self._closed = False
        self._lock = threading.RLock()
        self.lanes = [_Lane(s, i, self) for i, s in enumerate(socks)]
        self._bulk_rr = 0
        self._ledgers: Dict[int, _Ledger] = {}
        self._cbufs: Dict[int, _Coalesce] = {}
        self._last_flush: Dict[int, float] = {}
        self._window = port.config.coalesce_window_us * 1e-6

        reg = _counters.default()
        p = f"/net{{locality#{self.local_id}/peer#{peer_id}}}"
        self.c_parcels_sent = reg.counter(f"{p}/parcels/sent")
        self.c_parcels_recv = reg.counter(f"{p}/parcels/received")
        self.c_frames_sent = reg.counter(f"{p}/frames/sent")
        self.c_frames_recv = reg.counter(f"{p}/frames/received")
        self.c_bytes_sent = reg.counter(f"{p}/bytes/sent")
        self.c_bytes_recv = reg.counter(f"{p}/bytes/received")
        self.c_co_flushes = reg.counter(f"{p}/coalesce/flushes")
        self.c_co_parcels = reg.counter(f"{p}/coalesce/parcels")
        self.c_rdv_sent = reg.counter(f"{p}/rendezvous/sent")
        self.c_rdv_recv = reg.counter(f"{p}/rendezvous/received")
        self.c_blocked = reg.counter(f"{p}/credit/blocked")
        self.c_deferred = reg.counter(f"{p}/credit/deferred")
        self.g_inflight = reg.gauge(f"{p}/credit/inflight_bytes")

    # ------------------------------------------------------------ public api
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self.port._close_channel(self)

    def send(self, header: Dict[str, Any], payload: Any = _NO_PAYLOAD,
             can_block: Optional[bool] = None) -> None:
        """Ship one logical frame, choosing the protocol tier.

        Small payloads go eager (coalescable; parcels consume credit and
        may block the calling thread under backpressure).  Large payloads
        go rendezvous: only a tiny RTS leaves here, the stream follows on
        the bulk lanes after the CTS."""
        if self._closed:
            raise PortClosed(f"connection to locality#{self.peer_id} closed")
        t = header.get("t")
        try:
            body, views = _encode_body(payload)
        except Exception as e:  # noqa: BLE001 — degrade results, raise else
            if t != RESULT:
                raise
            header, body, views = _degrade_result(header, payload, e)
        if t in (PARCEL, RESULT):
            self.c_parcels_sent.increment()
        size = len(body) + sum(v.nbytes for v in views)
        cfg = self.port.config
        if size >= cfg.eager_threshold and t in (PARCEL, RESULT):
            self._send_rendezvous(header, body, views, size)
            return
        chunks = _assemble(header, body, views)
        if can_block is None:
            can_block = not _is_runtime_thread()
        if t == PARCEL:
            if self._admit(header.get("dst", self.peer_id), chunks,
                           can_block):
                self._coalesce_or_send(header.get("dst", self.peer_id),
                                       chunks)
        elif t in (HELLO, BYE, DOWN):
            # lifecycle frames bypass coalescing (BYE flushes first so no
            # queued frame is stranded behind the goodbye)
            if t == BYE:
                with self._lock:
                    for dst in list(self._cbufs):
                        self._flush_locked(dst)
            self.enqueue(0, chunks)
        else:
            self._coalesce_or_send(header.get("dst", self.peer_id), chunks)

    def send_control(self, header: Dict[str, Any]) -> None:
        """Payload-free control frame (CREDIT/CTS/...): eager, coalescable,
        credit-exempt, never blocks."""
        self._coalesce_or_send(header.get("dst", self.peer_id),
                               _assemble(header, b"", []))

    # --------------------------------------------------------- backpressure
    def _ledger(self, dst: int) -> _Ledger:
        led = self._ledgers.get(dst)
        if led is None:
            led = self._ledgers.setdefault(dst, _Ledger(self._lock))
        return led

    def _admit(self, dst: int, chunks: List[Any], can_block: bool) -> bool:
        """Charge one eager parcel against the destination's send budget.

        Returns True when the frame may be sent now; False when it was
        parked on the deferred FIFO (drained by incoming CREDIT)."""
        nbytes = _chunks_nbytes(chunks)
        budget = self.port.config.send_budget
        led = self._ledger(dst)

        def over() -> bool:
            # a parcel bigger than the whole budget still goes — alone —
            # once the wire is quiet (otherwise it would block forever)
            return bool(led.deferred) or (
                led.inflight > 0 and led.inflight + nbytes > budget)

        with self._lock:
            if over() and not can_block:
                led.deferred.append((chunks, nbytes))
                self.c_deferred.increment()
                if _trace._enabled:
                    # Waiting (W): parcel parked on the deferred FIFO until
                    # CREDIT returns — visible contention, not lost time
                    _trace.instant("credit/defer", "net", dst=dst,
                                   bytes=nbytes)
                return False
            if over():
                self.c_blocked.increment()
                t_blk = time.perf_counter() if _trace._enabled else 0.0
                deadline = time.monotonic() + self.port.config.block_timeout
                while not self._closed and over():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise PortClosed(
                            f"send to locality#{dst} blocked longer than "
                            f"{self.port.config.block_timeout}s by "
                            f"backpressure ({led.inflight} bytes unacked)")
                    led.cv.wait(timeout=min(remaining, 1.0))
                if t_blk:
                    # Waiting (W): the sender thread sat in cv.wait until
                    # enough CREDIT flowed back
                    _trace.complete("credit/block", "net", t_blk, dst=dst,
                                    bytes=nbytes)
            if self._closed:
                raise PortClosed(
                    f"connection to locality#{self.peer_id} closed")
            led.inflight += nbytes
            self.g_inflight.set(sum(l.inflight
                                    for l in self._ledgers.values()))
        return True

    def _on_credit(self, src: int, n: int) -> None:
        """CREDIT from ``src`` arrived: release budget, drain deferred."""
        budget = self.port.config.send_budget
        ready: List[List[Any]] = []
        with self._lock:
            led = self._ledger(src)
            led.inflight = max(0, led.inflight - n)
            while led.deferred and (
                    led.inflight == 0
                    or led.inflight + led.deferred[0][1] <= budget):
                chunks, nb = led.deferred.popleft()
                led.inflight += nb
                ready.append(chunks)
            self.g_inflight.set(sum(l.inflight
                                    for l in self._ledgers.values()))
            led.cv.notify_all()
        for chunks in ready:
            self._coalesce_or_send(src, chunks)

    def inflight_bytes(self, dst: Optional[int] = None) -> int:
        with self._lock:
            if dst is not None:
                return self._ledger(dst).inflight
            return sum(l.inflight for l in self._ledgers.values())

    # ----------------------------------------------------------- coalescing
    def _coalesce_or_send(self, dst: int, chunks: List[Any]) -> None:
        """Aggregation policy: first frame after a quiet period goes out
        immediately; frames inside the window pile into a container."""
        now = time.monotonic()
        created = False
        with self._lock:
            if self._closed:
                raise PortClosed(
                    f"connection to locality#{self.peer_id} closed")
            buf = self._cbufs.get(dst)
            if buf is None:
                if now - self._last_flush.get(dst, 0.0) >= self._window:
                    self._last_flush[dst] = now
                    self.enqueue(0, chunks)
                    return
                buf = self._cbufs[dst] = _Coalesce(now + self._window)
                created = True
            buf.parts.append(chunks)
            buf.count += 1
            buf.nbytes += _chunks_nbytes(chunks)
            cfg = self.port.config
            if (buf.nbytes >= cfg.coalesce_max_bytes
                    or buf.count >= cfg.coalesce_max_parcels):
                self._flush_locked(dst)
                return
        if created:
            self.port.wake()  # (re)arm the progress thread's flush timer

    def _flush_locked(self, dst: int, reason: str = "size") -> None:
        buf = self._cbufs.pop(dst, None)
        if buf is None:
            return
        if reason == "deadline" and _trace._enabled:
            # Overhead (O): these parcels sat out the aggregation window
            # without filling the container — latency traded for bandwidth
            _trace.instant("coalesce/deadline_flush", "net", dst=dst,
                           parcels=buf.count, bytes=buf.nbytes)
        self._last_flush[dst] = time.monotonic()
        self._adapt_window(buf)
        if buf.count == 1:
            self.enqueue(0, buf.parts[0])
            return
        header = {"t": MULTI, "src": self.local_id, "dst": dst,
                  "n": buf.count}
        hdr = _encode_header(header)
        inner = sum(_chunks_nbytes(p) for p in buf.parts)
        prefix = bytearray(8)
        _U32.pack_into(prefix, 0, 4 + len(hdr) + inner)
        _U32.pack_into(prefix, 4, len(hdr))
        chunks: List[Any] = [b"".join((prefix, hdr))]
        for part in buf.parts:
            chunks.extend(part)
        self.c_co_flushes.increment()
        self.c_co_parcels.increment(buf.count)
        self.enqueue(0, chunks)

    def _adapt_window(self, buf: _Coalesce) -> None:
        """Short adaptive timer: grow toward the cap while containers fill
        up, shrink toward the floor while they stay near-empty."""
        cfg = self.port.config
        if buf.nbytes >= cfg.coalesce_max_bytes or \
                buf.count >= cfg.coalesce_max_parcels:
            self._window = min(self._window * 1.5,
                               cfg.coalesce_window_us * 1e-6)
        elif buf.count <= 1:
            self._window = max(self._window * 0.5,
                               cfg.coalesce_min_window_us * 1e-6)

    def _flush_expired(self, now: float) -> Optional[float]:
        """Progress-thread tick: flush overdue buffers, return the next
        deadline (or None when nothing is buffered)."""
        nxt: Optional[float] = None
        with self._lock:
            for dst in list(self._cbufs):
                dl = self._cbufs[dst].deadline
                if dl <= now:
                    self._flush_locked(dst, reason="deadline")
                elif nxt is None or dl < nxt:
                    nxt = dl
        return nxt

    # ----------------------------------------------------------- rendezvous
    def _send_rendezvous(self, header: Dict[str, Any], body: bytes,
                         views: List[memoryview], size: int) -> None:
        header = dict(header)
        header["blens"] = [v.nbytes for v in views]
        header["bodylen"] = len(body)
        stream: List[memoryview] = [memoryview(body), *views]
        xfer = _OutXfer(0, header.get("dst", self.peer_id), stream, size)
        if _trace._enabled:
            xfer.t0 = time.perf_counter()
        xid = self.port._register_out(xfer)
        rts = {"t": RTS, "src": self.local_id,
               "dst": header.get("dst", self.peer_id), "x": xid,
               "size": size, "h": header}
        self.send_control(rts)

    def _stream_data(self, xfer: _OutXfer) -> None:
        """CTS granted: stripe the stream across the bulk lanes (progress
        thread; slicing views only — no payload copies)."""
        chunk = self.port.config.stripe_chunk
        off = 0
        seg_i, seg_off = 0, 0
        while off < xfer.size:
            n = min(chunk, xfer.size - off)
            pieces: List[Any] = []
            need = n
            while need > 0:
                seg = xfer.stream[seg_i]
                take = min(need, seg.nbytes - seg_off)
                if take:
                    pieces.append(seg[seg_off:seg_off + take])
                seg_off += take
                need -= take
                if seg_off >= seg.nbytes:
                    seg_i += 1
                    seg_off = 0
            hdr = _encode_header({"t": DATA, "src": self.local_id,
                                  "dst": xfer.dst, "x": xfer.xid,
                                  "o": off, "n": n})
            prefix = bytearray(8)
            _U32.pack_into(prefix, 0, 4 + len(hdr) + n)
            _U32.pack_into(prefix, 4, len(hdr))
            self.enqueue_bulk([b"".join((prefix, hdr)), *pieces])
            off += n
        self.c_rdv_sent.increment()

    # ------------------------------------------------------------- enqueue
    def enqueue(self, lane_idx: int, chunks: List[Any]) -> None:
        """Queue one frame on a lane, trying a direct non-blocking write
        when the lane is idle (no progress-thread wakeup on the fast
        path)."""
        lane = self.lanes[lane_idx]
        with lane.wlock:
            if self._closed:
                raise PortClosed(
                    f"connection to locality#{self.peer_id} closed")
            idle = not lane.wq
            lane.wq.append(chunks)
            if idle:
                lane.wstart = time.perf_counter() if _trace._enabled else 0.0
                done = self.port._write_lane_locked(lane)
                if done:
                    return
            lane.want_write = True
        self.port.wake()

    def enqueue_bulk(self, chunks: List[Any]) -> None:
        """Round-robin a DATA frame onto the bulk lanes (lane 0 carries
        bulk only in the degenerate ``stripes == 0`` configuration)."""
        if len(self.lanes) == 1:
            self.enqueue(0, chunks)
            return
        self._bulk_rr = self._bulk_rr % (len(self.lanes) - 1) + 1
        self.enqueue(self._bulk_rr, chunks)

    def forward(self, fr: Frame) -> None:
        """Root frame switch: re-prefix a parsed frame toward its dst
        without re-encoding header or payload bytes."""
        chunks = reframe(fr.hbytes, fr.rest)
        if fr.header.get("t") == DATA:
            self.enqueue_bulk(chunks)
        else:
            self.enqueue(0, chunks)

    # ---------------------------------------------------------------- close
    def _mark_closed(self) -> None:
        with self._lock:
            self._closed = True
            for led in self._ledgers.values():
                led.cv.notify_all()


# ------------------------------------------------------------------ the port
class PortHooks:
    """Callbacks a :class:`Port` needs from the runtime above it.

    ``deliver(fr, channel)`` — an application frame (parcel/result/bye/
    down) addressed to this locality; runs on the progress thread, must
    stay cheap.  ``route(dst)`` — the channel toward ``dst`` (the root's
    switch table).  ``forward_failed(fr)`` — a frame could not be
    forwarded (dest down).  ``on_forwarded()`` — switch accounting.
    ``on_close(channel)`` — a channel died.
    """

    def deliver(self, fr: Frame, channel: Channel) -> None:  # pragma: no cover
        raise NotImplementedError

    def route(self, dst: int) -> Channel:  # pragma: no cover
        raise NotImplementedError

    def forward_failed(self, fr: Frame) -> None:
        pass

    def on_forwarded(self) -> None:
        pass

    def on_close(self, channel: Channel) -> None:
        pass


class Port:
    """One per locality: the dedicated progress thread and every channel.

    All sockets are non-blocking and multiplexed through one
    ``selectors`` readiness loop — the LCI study's dedicated progress
    resource — which also runs the coalesce flush timers and the
    rendezvous handshake state machines."""

    def __init__(self, local_id: int, hooks: PortHooks,
                 config: Optional[NetConfig] = None):
        self.local_id = local_id
        self.hooks = hooks
        self.config = config or NetConfig()
        self._sel = selectors.DefaultSelector()
        self._channels: List[Channel] = []
        self._lock = threading.Lock()
        self._stopping = False
        self._started = False
        self._xid = 0
        self._outx: Dict[int, _OutXfer] = {}
        self._inx: Dict[Tuple[int, int], _InXfer] = {}
        self._pending_rts: Dict[int, "collections.deque[Dict[str, Any]]"] = {}
        self._reap: List[Channel] = []
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._waker_w.setblocking(False)
        self._sel.register(self._waker_r, selectors.EVENT_READ, None)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"repro-net-progress-{local_id}")

    # ------------------------------------------------------------- lifecycle
    def add_channel(self, peer_id: int,
                    socks: List[socket.socket]) -> Channel:
        ch = Channel(self, peer_id, socks)
        with self._lock:
            self._channels.append(ch)
            for lane in ch.lanes:
                self._sel.register(lane.sock, selectors.EVENT_READ, lane)
            if not self._started:
                self._started = True
                self._thread.start()
        self.wake()
        return ch

    def wake(self) -> None:
        try:
            self._waker_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # wake pipe full → the loop is already waking up

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every lane's write queue drains (BYE delivery)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            busy = any(lane.wq for ch in list(self._channels)
                       for lane in ch.lanes if not ch.closed)
            with self._lock:
                busy = busy or any(ch._cbufs for ch in self._channels
                                   if not ch.closed)
            if not busy:
                return True
            self.wake()
            time.sleep(0.002)
        return False

    def _close_channel(self, ch: Channel) -> None:
        if ch._closed:
            return
        ch._mark_closed()
        with self._lock:
            self._reap.append(ch)
        if self._thread.is_alive():
            self.wake()
        else:
            self._reap_closed()

    def close(self) -> None:
        self._stopping = True
        self.wake()
        if self._started and self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout=10.0)
        for ch in list(self._channels):
            ch._mark_closed()
            with self._lock:
                if ch not in self._reap:
                    self._reap.append(ch)
        self._reap_closed(notify=False)
        try:
            self._sel.close()
        except Exception:  # noqa: BLE001
            pass
        for s in (self._waker_r, self._waker_w):
            try:
                s.close()
            except OSError:
                pass

    def _reap_closed(self, notify: bool = True) -> None:
        with self._lock:
            doomed, self._reap = self._reap, []
        for ch in doomed:
            ch._mark_closed()  # idempotent; covers the deferred-close path
            for lane in ch.lanes:
                try:
                    self._sel.unregister(lane.sock)
                except (KeyError, ValueError):
                    pass
                try:
                    lane.sock.close()
                except OSError:
                    pass
            with self._lock:
                if ch in self._channels:
                    self._channels.remove(ch)
            # drop transfer state that can never complete
            for xid in [x for x, xf in self._outx.items()
                        if self._safe_route(xf.dst) is None]:
                self._outx.pop(xid, None)
            self._inx = {k: v for k, v in self._inx.items()
                         if k[0] != ch.peer_id}
            self._pending_rts.pop(ch.peer_id, None)
            if notify:
                try:
                    self.hooks.on_close(ch)
                except Exception:  # noqa: BLE001 — must not kill the loop
                    import traceback

                    traceback.print_exc()

    def drop_transfers(self, peer: int) -> None:
        """Abandon every rendezvous involving ``peer`` (it died): parked
        out-streams, half-built assemblies, queued RTS grants."""
        with self._lock:
            for xid in [x for x, xf in self._outx.items() if xf.dst == peer]:
                self._outx.pop(xid, None)
            self._inx = {k: v for k, v in self._inx.items() if k[0] != peer}
            self._pending_rts.pop(peer, None)

    def _register_out(self, xfer: _OutXfer) -> int:
        with self._lock:
            self._xid += 1
            xfer.xid = self._xid
            self._outx[xfer.xid] = xfer
            return xfer.xid

    def _safe_route(self, dst: int) -> Optional[Channel]:
        try:
            return self.hooks.route(dst)
        except PortClosed:
            return None

    # ---------------------------------------------------------- progress loop
    def _run(self) -> None:
        while not self._stopping:
            now = time.monotonic()
            nxt: Optional[float] = None
            for ch in list(self._channels):
                if ch.closed:
                    continue
                dl = ch._flush_expired(now)
                if dl is not None and (nxt is None or dl < nxt):
                    nxt = dl
            timeout = 0.1 if nxt is None else max(0.0, nxt - now)
            try:
                events = self._sel.select(min(timeout, 0.1))
            except OSError:
                if self._stopping:
                    return
                continue
            for key, mask in events:
                lane = key.data
                if lane is None:  # waker
                    try:
                        while self._waker_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                if lane.channel.closed:
                    continue
                if mask & selectors.EVENT_READ:
                    self._on_readable(lane)
                if mask & selectors.EVENT_WRITE and not lane.channel.closed:
                    self._service_write(lane)
            self._apply_write_interest()
            self._reap_closed()

    def _apply_write_interest(self) -> None:
        for ch in list(self._channels):
            if ch.closed:
                continue
            for lane in ch.lanes:
                with lane.wlock:
                    want = bool(lane.wq)
                    lane.want_write = want
                try:
                    self._sel.modify(
                        lane.sock,
                        selectors.EVENT_READ |
                        (selectors.EVENT_WRITE if want else 0), lane)
                except (KeyError, ValueError, OSError):
                    pass

    # -------------------------------------------------------------- writing
    def _service_write(self, lane: _Lane) -> None:
        with lane.wlock:
            self._write_lane_locked(lane)

    def _write_lane_locked(self, lane: _Lane) -> bool:
        """Write as much of the lane's queue as the kernel accepts.
        Returns True when the queue fully drained.  Caller holds wlock."""
        ch = lane.channel
        try:
            while lane.wq:
                chunks = lane.wq[0]
                views: List[memoryview] = []
                skip = lane.woff
                total = 0
                for c in chunks:
                    m = memoryview(c)
                    if m.ndim != 1 or m.format != "B":
                        m = m.cast("B")
                    if skip >= m.nbytes:
                        skip -= m.nbytes
                        continue
                    if skip:
                        m = m[skip:]
                        skip = 0
                    views.append(m)
                    total += m.nbytes
                    if len(views) >= 64:
                        break
                sent = lane.sock.sendmsg(views)
                lane.woff += sent
                lane.bytes_written += sent
                ch.c_bytes_sent.increment(sent)
                if sent < total:
                    return False  # kernel buffer full mid-frame
                if len(views) >= 64 and lane.woff < _chunks_nbytes(chunks):
                    continue  # >64-chunk frame: keep feeding the kernel
                # frame fully written
                lane.wq.popleft()
                lane.woff = 0
                ch.c_frames_sent.increment()
                if _trace._enabled:
                    _trace.complete("wire/send", "net", lane.wstart or
                                    time.perf_counter(),
                                    bytes=_chunks_nbytes(chunks),
                                    peer=ch.peer_id, lane=lane.idx)
                    lane.wstart = time.perf_counter()
            return True
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            # can't take ch._lock here (caller holds lane.wlock; the lock
            # order is channel → lane) — park the channel for the progress
            # thread to reap instead of closing inline
            lane.wq.clear()
            with self._lock:
                if ch not in self._reap:
                    self._reap.append(ch)
            self.wake()
            return True

    # -------------------------------------------------------------- reading
    def _on_readable(self, lane: _Lane) -> None:
        ch = lane.channel
        try:
            while True:
                if lane.rlo == lane.rhi:
                    # big rest remaining → read straight into the sink
                    if (lane.rphase == 2 and lane.rrest is not None
                            and lane.rrest_len - lane.rrest_got >= 4096):
                        n = lane.sock.recv_into(
                            lane.rrest[lane.rrest_got:])
                        if n == 0:
                            raise PortClosed("peer closed the connection")
                        lane.bytes_read += n
                        ch.c_bytes_recv.increment(n)
                        lane.rrest_got += n
                        if lane.rrest_got >= lane.rrest_len:
                            self._frame_complete(lane)
                        continue
                    lane.rlo = lane.rhi = 0
                    n = lane.sock.recv_into(lane.rscratch)
                    if n == 0:
                        raise PortClosed("peer closed the connection")
                    lane.bytes_read += n
                    ch.c_bytes_recv.increment(n)
                    lane.rhi = n
                self._feed(lane)
        except (BlockingIOError, InterruptedError):
            return
        except (OSError, PortClosed):
            ch.close()
        except Exception:  # noqa: BLE001 — a bad frame must not kill the loop
            import traceback

            traceback.print_exc()
            ch.close()

    def _feed(self, lane: _Lane) -> None:
        """Advance the lane's frame state machine over buffered bytes."""
        scratch = memoryview(lane.rscratch)
        while lane.rlo < lane.rhi:
            avail = lane.rhi - lane.rlo
            if lane.rphase == 0:
                take = min(avail, 8 - lane.rpre_got)
                lane.rpre[lane.rpre_got:lane.rpre_got + take] = \
                    scratch[lane.rlo:lane.rlo + take]
                lane.rpre_got += take
                lane.rlo += take
                if lane.rpre_got < 8:
                    return
                lane.rtotal = _U32.unpack_from(lane.rpre, 0)[0]
                hlen = _U32.unpack_from(lane.rpre, 4)[0]
                lane.rhdr = bytearray(hlen)
                lane.rhdr_got = 0
                lane.rrest_len = lane.rtotal - 4 - hlen
                lane.rphase = 1
            elif lane.rphase == 1:
                hlen = len(lane.rhdr)
                take = min(avail, hlen - lane.rhdr_got)
                lane.rhdr[lane.rhdr_got:lane.rhdr_got + take] = \
                    scratch[lane.rlo:lane.rlo + take]
                lane.rhdr_got += take
                lane.rlo += take
                if lane.rhdr_got < hlen:
                    return
                lane.rheader = _decode_header(bytes(lane.rhdr))
                lane.rassembly = None
                if lane.rrest_len == 0:
                    lane.rrest = memoryview(b"")
                    lane.rrest_got = 0
                    self._frame_complete(lane)
                    continue
                h = lane.rheader
                if (h.get("t") == DATA
                        and h.get("dst", self.local_id) == self.local_id):
                    xf = self._inx.get((h.get("src"), h.get("x")))
                    if xf is not None:
                        lane.rassembly = xf
                        o = h.get("o", 0)
                        lane.rrest = memoryview(xf.buf)[o:o + lane.rrest_len]
                        lane.rrest_got = 0
                        lane.rphase = 2
                        continue
                lane.rrest = memoryview(bytearray(lane.rrest_len))
                lane.rrest_got = 0
                lane.rphase = 2
            else:  # rest
                take = min(avail, lane.rrest_len - lane.rrest_got)
                lane.rrest[lane.rrest_got:lane.rrest_got + take] = \
                    scratch[lane.rlo:lane.rlo + take]
                lane.rrest_got += take
                lane.rlo += take
                if lane.rrest_got < lane.rrest_len:
                    return
                self._frame_complete(lane)

    def _frame_complete(self, lane: _Lane) -> None:
        header, rest = lane.rheader, lane.rrest
        assembly = lane.rassembly
        hbytes = bytes(lane.rhdr)
        wire = 4 + lane.rtotal
        lane.rphase = 0
        lane.rpre_got = 0
        lane.rheader = None
        lane.rrest = None
        lane.rassembly = None
        ch = lane.channel
        ch.c_frames_recv.increment()
        if _trace._enabled:
            _trace.instant("wire/recv", "net", bytes=wire,
                           peer=ch.peer_id, lane=lane.idx)
        if assembly is not None:
            self._data_written(ch, assembly, header)
            return
        self._dispatch(ch, Frame(header, hbytes, rest, wire, wire))

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, ch: Channel, fr: Frame) -> None:
        header = fr.header
        t = header.get("t")
        dst = header.get("dst", self.local_id)
        if dst != self.local_id and t in _FORWARDABLE:
            out = self._safe_route(dst)
            if out is None or out.closed:
                self.hooks.forward_failed(fr)
                return
            self.hooks.on_forwarded()
            try:
                out.forward(fr)
            except PortClosed:
                self.hooks.forward_failed(fr)
            return
        if t == MULTI:
            for shdr, hb, srest, wire in iter_multi(header, fr.rest):
                self._dispatch(ch, Frame(shdr, hb, srest, wire, wire))
        elif t == CREDIT:
            ch._on_credit(header.get("src"), header.get("n", 0))
        elif t == RTS:
            self._on_rts(ch, header)
        elif t == CTS:
            xf = self._outx.pop(header.get("x"), None)
            if xf is not None:
                if xf.t0 and _trace._enabled:
                    # Waiting (W): payload parked sender-side from RTS send
                    # until the receiver granted CTS
                    _trace.complete("rendezvous/cts_wait", "net", xf.t0,
                                    dst=xf.dst, bytes=xf.size)
                out = self._safe_route(xf.dst)
                if out is not None and not out.closed:
                    out._stream_data(xf)
        elif t == DATA:
            # DATA for an unknown assembly (sender raced a close): drop.
            pass
        else:
            if t in (PARCEL, RESULT):
                ch.c_parcels_recv.increment()
            self.hooks.deliver(fr, ch)

    def _on_rts(self, ch: Channel, header: Dict[str, Any]) -> None:
        src = header.get("src")
        active = sum(1 for k in self._inx if k[0] == src)
        if active >= self.config.max_rendezvous:
            self._pending_rts.setdefault(
                src, collections.deque()).append(header)
            return
        self._grant_rts(header)

    def _grant_rts(self, header: Dict[str, Any]) -> None:
        src = header.get("src")
        xid = header.get("x")
        xf = _InXfer(src, xid, header.get("h") or {}, header.get("size", 0))
        self._inx[(src, xid)] = xf
        out = self._safe_route(src)
        if out is None or out.closed:
            self._inx.pop((src, xid), None)
            return
        out.send_control({"t": CTS, "src": self.local_id, "dst": src,
                          "x": xid})
        if xf.size == 0:  # degenerate empty payload: complete immediately
            self._complete_assembly(out, xf)

    def _data_written(self, ch: Channel, xf: _InXfer,
                      header: Dict[str, Any]) -> None:
        xf.got += header.get("n", 0)
        if xf.got >= xf.size:
            self._complete_assembly(ch, xf)

    def _complete_assembly(self, ch: Channel, xf: _InXfer) -> None:
        self._inx.pop((xf.src, xf.xid), None)
        ch.c_rdv_recv.increment()
        inner = dict(xf.header)
        if inner.get("t") in (PARCEL, RESULT):
            ch.c_parcels_recv.increment()
        # rendezvous parcels never consumed eager credit: credit_bytes=0
        self.hooks.deliver(Frame(inner, b"", memoryview(xf.buf),
                                 xf.size, 0), ch)
        q = self._pending_rts.get(xf.src)
        if q:
            self._grant_rts(q.popleft())
            if not q:
                self._pending_rts.pop(xf.src, None)
