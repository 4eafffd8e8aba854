"""The port's parcelport (``repro_torch.net.parcelport``) against the
reference's: the frame codec (``tests/test_net_parcelport.py``'s cases) and
the transport tiers (``tests/test_net_transport.py``'s: coalescing,
rendezvous striping, credit backpressure, wire failure modes).

- Codec and in-process transport cases run on both packages (``pkg``):
  the same frames in, the same frames, counters and failures out; a
  payload that holds no tensor encodes to the reference's bytes.
- Torch payloads: fp32, bf16, int64, bool, 0-dim, empty and
  non-contiguous tensors, nested in dicts, lists and NamedTuples, arrive
  as the values the reference delivers for the same arrays (numpy; bf16
  as a bf16 tensor, numpy having none), and a contiguous CPU tensor rides
  out of band without a copy.
- The failure modes above the port (a peer dying mid-call, the root's
  DOWN broadcast, backpressure draining) run on a real port fleet.

Helper actions are module-level so spawned workers resolve them by
dotted name (``test_torch_net_parcelport.<fn>``)."""

import collections
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.net import parcelport as rpp
from repro_torch.net import parcelport as tpp

PKGS = {"ref": rpp, "port": tpp}
Point = collections.namedtuple("Point", ["x", "y"])
Rec = collections.namedtuple("Rec", ["a", "b"])


# ----------------------------------------------- worker-resolvable helpers
def call_slow_peer(rt, dst):
    """Runs on a worker: call ``_slow_sink`` on another worker and report
    how the pending future ends when that worker dies mid-call."""
    from repro_torch.net import remote

    try:
        fut = rt.send_parcel(dst, remote._slow_sink._action_name, None,
                             (b"x" * 64, 30.0))
        fut.get(timeout=25)
        return "completed"
    except tpp.PortClosed:
        return "portclosed"


def echo_len(rt, payload):
    return len(payload)


# ------------------------------------------------------------------- codec
def _round_trip(pp, header, payload=None):
    chunks = (pp.encode_frame(header) if payload is None
              else pp.encode_frame(header, payload))
    wire = b"".join(bytes(c) for c in chunks)
    total = int.from_bytes(wire[:4], "big")
    assert total == len(wire) - 4
    hdr, rest = pp.decode_frame(memoryview(wire[4:]))
    return hdr, pp.decode_payload(hdr, rest)


def _pheader(pp):
    return {"t": pp.PARCEL, "src": 0, "dst": 1, "seq": 1, "a": "f", "g": None}


@pytest.mark.parametrize("pkg", PKGS)
def test_header_only_frame(pkg):
    pp = PKGS[pkg]
    hdr, payload = _round_trip(pp, {"t": pp.HELLO, "src": 3, "dst": 0, "seq": 0})
    assert hdr["t"] == pp.HELLO and hdr["src"] == 3
    assert payload is None


@pytest.mark.parametrize("pkg", PKGS)
def test_payload_with_nested_arrays_out_of_band(pkg):
    pp = PKGS[pkg]
    args = ({"x": np.arange(64, dtype=np.float32),
             "y": [np.ones((4, 4)), "text", 7]},)
    header = {"t": pp.PARCEL, "src": 0, "dst": 1, "seq": 5, "a": "mod.fn", "g": [1, 2]}
    hdr, payload = _round_trip(pp, header, (args, {}))
    assert len(hdr["blens"]) >= 2
    assert sum(hdr["blens"]) >= 64 * 4 + 16 * 8
    (got,), kwargs = payload
    np.testing.assert_array_equal(got["x"], args[0]["x"])
    np.testing.assert_array_equal(got["y"][0], np.ones((4, 4)))
    assert got["y"][1:] == ["text", 7] and kwargs == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_send_side_chunks_alias_source_buffer(pkg):
    pp = PKGS[pkg]
    arr = np.arange(1024, dtype=np.int64)
    chunks = pp.encode_frame(_pheader(pp), ((arr,), {}))
    views = [c for c in chunks[1:] if isinstance(c, memoryview)]
    assert views, "array buffer should travel out of band"
    arr[0] = -1
    assert np.frombuffer(views[0], dtype=np.int64)[0] == -1


@pytest.mark.parametrize("pkg", PKGS)
def test_exception_payload_round_trips(pkg):
    pp = PKGS[pkg]
    chunks = pp.encode_result_payload({"t": pp.RESULT, "src": 1, "dst": 0, "seq": 9},
                                      None, ValueError("bad"))
    wire = b"".join(bytes(c) for c in chunks)
    hdr, rest = pp.decode_frame(memoryview(wire[4:]))
    exc = pp.decode_payload(hdr, rest)
    assert hdr["ok"] is False and isinstance(exc, ValueError) and exc.args == ("bad",)


@pytest.mark.parametrize("pkg", PKGS)
def test_unpicklable_result_degrades_to_runtime_error(pkg):
    pp = PKGS[pkg]
    chunks = pp.encode_result_payload({"t": pp.RESULT, "src": 1, "dst": 0, "seq": 9},
                                      lambda: 0, None)
    wire = b"".join(bytes(c) for c in chunks)
    hdr, rest = pp.decode_frame(memoryview(wire[4:]))
    exc = pp.decode_payload(hdr, rest)
    assert hdr["ok"] is False and isinstance(exc, RuntimeError)
    assert "unpicklable" in str(exc)


@pytest.mark.parametrize("pkg", PKGS)
def test_forward_chunks_preserve_frame(pkg):
    pp = PKGS[pkg]
    header = {"t": pp.PARCEL, "src": 1, "dst": 2, "seq": 3, "a": "f", "g": [2, 1]}
    wire = b"".join(bytes(c) for c in pp.encode_frame(header, ((1, 2), {})))
    fwd = b"".join(bytes(c) for c in pp.forward_chunks(memoryview(wire[4:])))
    assert fwd == wire


TENSOR_FREE = {
    "none": None,
    "scalars": ((1, 2.5, "s", b"b", None, True), {"k": -3}),
    "nested": (({"a": [1, {"b": (2, 3)}], "c": "x" * 300},), {}),
    "arrays": ((np.arange(100, dtype=np.float32), np.ones((3, 4), np.int64)), {}),
    "namedtuple": ((Point(np.arange(4.0), "label"), Rec([1, 2], {"z": 0})), {}),
    "noncontig": ((np.arange(100).reshape(10, 10)[:, ::2],), {}),
    "exception": ValueError("boom", 3),
}


@pytest.mark.parametrize("case", list(TENSOR_FREE))
def test_tensor_free_payload_encodes_to_reference_bytes(case):
    """With torch imported, a payload that holds no tensor still goes
    through the reference's codec byte for byte (the header included)."""
    payload = TENSOR_FREE[case]
    header = {"t": rpp.PARCEL, "src": 2, "dst": 1, "seq": 7, "a": "m.f", "g": [1, 4]}
    args = () if payload is None else (payload,)
    ref = b"".join(bytes(c) for c in rpp.encode_frame(header, *args))
    port = b"".join(bytes(c) for c in tpp.encode_frame(header, *args))
    assert port == ref
    for kind in (rpp.HELLO, rpp.CREDIT, rpp.BYE):
        h = {"t": kind, "src": 1, "dst": 0, "seq": 0, "n": 5}
        assert (b"".join(bytes(c) for c in tpp.encode_frame(h))
                == b"".join(bytes(c) for c in rpp.encode_frame(h)))


def test_to_host_is_identity_for_tensor_free_payloads():
    arr = np.arange(1 << 16, dtype=np.float32)
    leaves = [arr, {"k": [arr, (1, "s")], "m": b"bytes"}, Rec(arr, [2, 3])]
    for obj in leaves:
        assert tpp._to_host(obj) is obj
    nested = {"outer": leaves, "t": tuple(leaves)}
    out = tpp._to_host(nested)
    assert out is nested and out["outer"] is leaves and out["outer"][0] is arr


def test_to_host_rebuilds_only_branches_holding_tensors():
    """The reference's rule for jax.Array leaves, held for torch ones."""
    import jax.numpy as jnp

    arr = np.arange(8, dtype=np.float32)
    clean = {"n": arr, "l": [1, 2]}
    outs = {}
    for name, pp, dev in (("ref", rpp, jnp.arange(4, dtype=jnp.float32)),
                          ("port", tpp, torch.arange(4, dtype=torch.float32))):
        mixed = {"clean": clean, "dev": dev}
        out = pp._to_host(mixed)
        assert out is not mixed and out["clean"] is clean
        assert isinstance(out["dev"], np.ndarray)
        outs[name] = out["dev"]
    np.testing.assert_array_equal(outs["port"], outs["ref"])


def _torch_cases():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(6, 8, generator=g)
    return {
        "fp32": base,
        "bf16": base.to(torch.bfloat16),
        "int64": torch.arange(-5, 7, dtype=torch.int64).reshape(3, 4),
        "bool": base > 0,
        "0d-fp32": torch.tensor(3.5),
        "0d-bf16": torch.tensor(-1.25, dtype=torch.bfloat16),
        "empty": torch.empty(0, 4),
        "empty-bf16": torch.empty(0, dtype=torch.bfloat16),
        "noncontig": base[:, ::2],
        "noncontig-bf16": base.to(torch.bfloat16).t(),
        "requires-grad": base.clone().requires_grad_(True),
    }


def _same(got, want: torch.Tensor):
    """``got`` is what the reference delivers for ``want``'s array: numpy,
    or a bf16 tensor where numpy has no dtype."""
    if want.dtype == torch.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == tuple(want.shape)
        assert torch.equal(got.view(torch.int16), want.detach().contiguous().view(torch.int16))
    else:
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want.detach().numpy())
        assert got.dtype == want.detach().numpy().dtype and got.shape == tuple(want.shape)


@pytest.mark.parametrize("case", list(_torch_cases()))
def test_torch_payload_round_trips_as_the_reference_delivers(case):
    import jax.numpy as jnp

    t = _torch_cases()[case]
    payload = ({"x": t, "l": [t, "tag", 7], "p": Point(t, "y")}, {"kw": (t,)})
    (got, kw) = _round_trip(tpp, _pheader(tpp), payload)[1]
    for leaf in (got["x"], got["l"][0], got["p"].x, kw["kw"][0]):
        _same(leaf, t)
    assert got["l"][1:] == ["tag", 7] and type(got["p"]).__name__ == "Point"
    # the reference, handed the same values as a jax array, delivers equal ones
    src = t.detach()
    ref_in = jnp.asarray(src.float().numpy()).astype(jnp.bfloat16) \
        if src.dtype == torch.bfloat16 else jnp.asarray(src.numpy())
    ref_got = _round_trip(rpp, _pheader(rpp), ((ref_in,), {}))[1][0][0]
    if src.dtype == torch.bfloat16:
        assert str(ref_got.dtype) == "bfloat16"
        assert np.array_equal(ref_got.view(np.int16), got["x"].view(torch.int16).numpy())
    else:
        np.testing.assert_array_equal(ref_got, got["x"])


def test_tensor_inside_an_object_never_takes_torchs_reducer():
    """A tensor the walk cannot reach (an attribute of another object)
    still crosses as host numpy, never as pickled torch storage."""
    holder = _Holder(torch.arange(5, dtype=torch.float32))
    (got,), _ = _round_trip(tpp, _pheader(tpp), ((holder,), {}))[1]
    assert isinstance(got.t, np.ndarray)
    np.testing.assert_array_equal(got.t, np.arange(5, dtype=np.float32))


class _Holder:
    def __init__(self, t):
        self.t = t


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64, torch.bfloat16, torch.uint8])
def test_contiguous_cpu_tensor_travels_out_of_band_without_a_copy(dtype):
    t = torch.arange(4096).to(dtype)
    chunks = tpp.encode_frame(_pheader(tpp), ((t,), {}))
    views = [c for c in chunks[1:] if isinstance(c, memoryview)]
    assert sum(v.nbytes for v in views) == t.numel() * t.element_size()
    assert len(chunks[0]) < 1024  # the header and body only: no bytes in band
    # aliasing: the view is the tensor's own memory
    t[0] = 7
    assert bytes(views[0][: t.element_size()]) == t[:1].view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("arr", [
    np.array(3.5), np.array(7, dtype=np.int32), np.empty((0,), np.float64),
    np.empty((0, 4), np.float32), np.arange(100).reshape(10, 10)[:, ::2],
    np.arange(100).reshape(10, 10)[::3], np.asfortranarray(np.arange(12.0).reshape(3, 4)),
], ids=["0d-f8", "0d-i4", "empty-1d", "empty-2d", "noncontig-cols", "strided-rows",
        "fortran"])
@pytest.mark.parametrize("pkg", PKGS)
def test_edge_payload_round_trips(pkg, arr):
    pp = PKGS[pkg]
    (got,), _ = _round_trip(pp, _pheader(pp), ((arr,), {}))[1]
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == arr.dtype and got.shape == arr.shape


from hypothesis import given, settings, strategies as st  # noqa: E402

_DTYPES = ["<f4", "<f8", "<i4", "<i8", "|u1"]


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 300), st.sampled_from(_DTYPES), st.booleans())
def test_codec_round_trip_property(n, dt, nest):
    arr = (np.arange(n) % 251).astype(np.dtype(dt))
    payload = {"x": arr, "y": [arr[: n // 2], "tag", 7]} if nest else ((arr,), {})
    for pp in PKGS.values():
        _hdr, got = _round_trip(pp, _pheader(pp), payload)
        back = got["x"] if nest else got[0][0]
        np.testing.assert_array_equal(back, arr)
        assert back.dtype == arr.dtype
    ref = b"".join(bytes(c) for c in rpp.encode_frame(_pheader(rpp), payload))
    assert b"".join(bytes(c) for c in tpp.encode_frame(_pheader(tpp), payload)) == ref


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4096), st.sampled_from(["float32", "float64", "int32", "int64",
                                              "uint8", "bfloat16"]))
def test_contiguous_tensors_stay_out_of_band(n, dt):
    t = (torch.arange(n) % 127).to(getattr(torch, dt))
    chunks = tpp.encode_frame(_pheader(tpp), ((t,), {}))
    views = [c for c in chunks[1:] if isinstance(c, memoryview)]
    assert sum(v.nbytes for v in views) >= t.numel() * t.element_size()
    first = views[0]
    t[0] += 1
    assert bytes(first[: t.element_size()]) == t[:1].view(torch.uint8).numpy().tobytes()


# ------------------------------------------------------- in-process ports
def _hooks_class(pp):
    class _Hooks(pp.PortHooks):
        """Collects delivered frames; optionally acks credit like the runtime."""

        def __init__(self, local_id, auto_credit=True):
            self.local_id = local_id
            self.auto_credit = auto_credit
            self.frames = []
            self.closed = []
            self.chan = None
            self._cv = threading.Condition()

        def deliver(self, fr, channel):
            with self._cv:
                self.frames.append(fr)
                self._cv.notify_all()
            if self.auto_credit and fr.header.get("t") == pp.PARCEL and fr.credit_bytes:
                channel.send_control({"t": pp.CREDIT, "src": self.local_id,
                                      "dst": fr.header["src"], "n": fr.credit_bytes})

        def route(self, dst):
            if self.chan is None or self.chan.closed:
                raise pp.PortClosed(f"no route to {dst}")
            return self.chan

        def on_close(self, channel):
            with self._cv:
                self.closed.append(channel)
                self._cv.notify_all()

        def wait_frames(self, n, timeout=15.0):
            deadline = time.monotonic() + timeout
            with self._cv:
                while len(self.frames) < n:
                    remaining = deadline - time.monotonic()
                    assert remaining > 0, f"timed out with {len(self.frames)}/{n} frames"
                    self._cv.wait(remaining)
                return list(self.frames)

        def wait_closed(self, timeout=15.0):
            deadline = time.monotonic() + timeout
            with self._cv:
                while not self.closed:
                    remaining = deadline - time.monotonic()
                    assert remaining > 0, "channel never closed"
                    self._cv.wait(remaining)

    return _Hooks


@pytest.fixture(params=list(PKGS))
def port_pair(request):
    """Factory for two in-process ports of one package, joined by
    socketpair lanes; yields (package, make)."""
    pp = PKGS[request.param]
    Hooks = _hooks_class(pp)
    ports = []

    def make(config=None, auto_credit_b=True):
        cfg = config or pp.NetConfig()
        nlanes = 1 + max(0, cfg.stripes)
        hooks_a, hooks_b = Hooks(0), Hooks(1, auto_credit=auto_credit_b)
        port_a, port_b = pp.Port(0, hooks_a, cfg), pp.Port(1, hooks_b, cfg)
        ports.extend((port_a, port_b))
        pairs = [socket.socketpair() for _ in range(nlanes)]
        hooks_a.chan = port_a.add_channel(1, [p[0] for p in pairs])
        hooks_b.chan = port_b.add_channel(0, [p[1] for p in pairs])
        return (port_a, hooks_a), (port_b, hooks_b)

    yield pp, make
    for port in ports:
        port.close()


def _parcel_header(pp, src, dst, seq, a="t.noop"):
    return {"t": pp.PARCEL, "src": src, "dst": dst, "seq": seq, "a": a, "g": None}


def _wait(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {msg}"
        time.sleep(0.002)


def test_eager_round_trip_and_credit_return(port_pair):
    pp, make = port_pair
    (_pa, ha), (_pb, hb) = make()
    ha.chan.send(_parcel_header(pp, 0, 1, 1), ((torch.arange(3), b"ping"), {}))
    fr = hb.wait_frames(1)[0]
    assert fr.header["a"] == "t.noop" and fr.credit_bytes == fr.wire_bytes > 0
    args, kwargs = pp.decode_payload(fr.header, fr.rest)
    assert args[1] == b"ping" and kwargs == {}
    np.testing.assert_array_equal(args[0], np.arange(3))
    _wait(lambda: ha.chan.inflight_bytes(1) == 0, msg="credit return")


def test_coalescing_packs_parcels_into_multi(port_pair):
    pp, make = port_pair
    cfg = pp.NetConfig(coalesce_window_us=120_000.0, coalesce_min_window_us=120_000.0)
    (_pa, ha), (_pb, hb) = make(cfg)
    ch = ha.chan
    sent0, frames0 = ch.c_parcels_sent.get_value(), ch.c_frames_sent.get_value()
    flush0, packed0 = ch.c_co_flushes.get_value(), ch.c_co_parcels.get_value()
    n = 40
    for i in range(n):
        ch.send(_parcel_header(pp, 0, 1, i + 1), ((i,), {}))
    got = hb.wait_frames(n)
    assert [pp.decode_payload(f.header, f.rest)[0][0] for f in got] == list(range(n))
    assert ch.c_parcels_sent.get_value() - sent0 == n
    assert ch.c_co_flushes.get_value() - flush0 >= 1
    assert ch.c_co_parcels.get_value() - packed0 >= 2
    assert ch.c_frames_sent.get_value() - frames0 < n
    _wait(lambda: ch.inflight_bytes(1) == 0, msg="credit after coalesce")


def test_first_frame_after_quiet_period_is_not_delayed(port_pair):
    pp, make = port_pair
    cfg = pp.NetConfig(coalesce_window_us=250_000.0, coalesce_min_window_us=250_000.0)
    (_pa, ha), (_pb, hb) = make(cfg)
    t0 = time.monotonic()
    ha.chan.send(_parcel_header(pp, 0, 1, 1), ((0,), {}))
    hb.wait_frames(1)
    assert time.monotonic() - t0 < 0.2


def test_rendezvous_stripes_across_bulk_lanes(port_pair):
    pp, make = port_pair
    cfg = pp.NetConfig(eager_threshold=4096, stripe_chunk=8192, stripes=2)
    (_pa, ha), (_pb, hb) = make(cfg)
    rdv_s0, rdv_r0 = ha.chan.c_rdv_sent.get_value(), hb.chan.c_rdv_recv.get_value()
    arr = torch.arange(64 * 1024).to(torch.uint8)
    ha.chan.send(_parcel_header(pp, 0, 1, 1), ((arr,), {}))
    fr = hb.wait_frames(1)[0]
    assert fr.credit_bytes == 0
    args, _ = pp.decode_payload(fr.header, fr.rest)
    np.testing.assert_array_equal(args[0], arr.numpy())
    assert ha.chan.c_rdv_sent.get_value() - rdv_s0 == 1
    assert hb.chan.c_rdv_recv.get_value() - rdv_r0 == 1
    assert all(lane.bytes_read > 0 for lane in hb.chan.lanes[1:])
    assert hb.chan.lanes[0].bytes_read < 4096


def test_rendezvous_empty_and_threshold_payloads(port_pair):
    pp, make = port_pair
    (_pa, ha), (_pb, hb) = make(pp.NetConfig(eager_threshold=1024, stripes=1))
    big, small = b"z" * 4096, b"s" * 16
    ha.chan.send(_parcel_header(pp, 0, 1, 1), ((big,), {}))
    ha.chan.send(_parcel_header(pp, 0, 1, 2), ((small,), {}))
    frames = hb.wait_frames(2)
    by_seq = {f.header["seq"]: pp.decode_payload(f.header, f.rest)[0][0] for f in frames}
    assert by_seq[1] == big and by_seq[2] == small


def test_rendezvous_bf16_tensor_arrives_bit_equal(port_pair):
    """A bf16 page pool travels the striped tier as its bits (the port) or
    as an ml_dtypes array (the reference): the same 16-bit pattern."""
    pp, make = port_pair
    (_pa, ha), (_pb, hb) = make(pp.NetConfig(eager_threshold=4096, stripe_chunk=8192))
    src = torch.randn(4, 64, 2, 16, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    if pp is rpp:
        import jax.numpy as jnp

        payload = jnp.asarray(src.float().numpy()).astype(jnp.bfloat16)
    else:
        payload = src
    ha.chan.send(_parcel_header(pp, 0, 1, 1), ((payload,), {}))
    fr = hb.wait_frames(1)[0]
    got = pp.decode_payload(fr.header, fr.rest)[0][0]
    bits = got.view(torch.int16).numpy() if pp is tpp else np.asarray(got).view(np.int16)
    assert np.array_equal(bits, src.view(torch.int16).numpy())


def test_backpressure_defers_runtime_sends_and_drains_on_credit(port_pair):
    pp, make = port_pair
    cfg = pp.NetConfig(send_budget=8192, coalesce_window_us=50.0, coalesce_min_window_us=50.0)
    (_pa, ha), (_pb, hb) = make(cfg, auto_credit_b=False)
    ch = ha.chan
    deferred0 = ch.c_deferred.get_value()
    n = 5
    for i in range(n):
        ch.send(_parcel_header(pp, 0, 1, i + 1), ((b"x" * 4096,), {}), can_block=False)
    assert ch.c_deferred.get_value() - deferred0 >= 3
    assert ch.inflight_bytes(1) <= cfg.send_budget
    for i in range(n):
        fr = hb.wait_frames(i + 1)[i]
        assert fr.header["seq"] == i + 1
        hb.chan.send_control({"t": pp.CREDIT, "src": 1, "dst": 0, "n": fr.credit_bytes})
    _wait(lambda: ch.inflight_bytes(1) == 0, msg="ledger drain")


def test_backpressure_blocks_producer_thread_until_credit(port_pair):
    pp, make = port_pair
    (_pa, ha), (_pb, hb) = make(pp.NetConfig(send_budget=4096), auto_credit_b=False)
    ch = ha.chan
    blocked0 = ch.c_blocked.get_value()

    def produce():
        for i in range(3):
            ch.send(_parcel_header(pp, 0, 1, i + 1), ((b"y" * 4096,), {}))

    t = threading.Thread(target=produce, name="producer")
    t.start()
    hb.wait_frames(1)
    _wait(lambda: ch.c_blocked.get_value() - blocked0 >= 1, msg="block")
    assert t.is_alive() and len(hb.frames) == 1
    for i in range(3):
        fr = hb.wait_frames(i + 1)[i]
        hb.chan.send_control({"t": pp.CREDIT, "src": 1, "dst": 0, "n": fr.credit_bytes})
    t.join(timeout=15.0)
    assert not t.is_alive()
    _wait(lambda: ch.inflight_bytes(1) == 0, msg="ledger drain")


@pytest.mark.parametrize("pkg", PKGS)
def test_truncated_frame_mid_stream_closes_channel(pkg):
    pp = PKGS[pkg]
    hooks = _hooks_class(pp)(1)
    port = pp.Port(1, hooks, pp.NetConfig(stripes=0))
    a_sock, b_sock = socket.socketpair()
    hooks.chan = port.add_channel(0, [b_sock])
    try:
        wire = b"".join(bytes(c) for c in pp.encode_frame(_parcel_header(pp, 0, 1, 1),
                                                          ((b"ok",), {})))
        torn = b"".join(bytes(c) for c in pp.encode_frame(_parcel_header(pp, 0, 1, 2),
                                                          ((b"lost",), {})))
        a_sock.sendall(wire + torn[: len(torn) // 2])
        hooks.wait_frames(1)
        time.sleep(0.05)
        a_sock.close()
        hooks.wait_closed()
        assert hooks.chan.closed and len(hooks.frames) == 1
        assert pp.decode_payload(hooks.frames[0].header, hooks.frames[0].rest)[0] == (b"ok",)
        with pytest.raises(pp.PortClosed):
            hooks.chan.send(_parcel_header(pp, 1, 0, 3), ((b"late",), {}))
    finally:
        a_sock.close()
        port.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_peer_death_mid_rendezvous_drops_assembly(pkg):
    pp = PKGS[pkg]
    hooks = _hooks_class(pp)(1)
    port = pp.Port(1, hooks, pp.NetConfig(eager_threshold=1024, stripes=0))
    a_sock, b_sock = socket.socketpair()
    hooks.chan = port.add_channel(0, [b_sock])
    try:
        inner = _parcel_header(pp, 0, 1, 1)
        inner["blens"], inner["bodylen"] = [], 8192
        rts = pp.encode_frame({"t": pp.RTS, "src": 0, "dst": 1, "x": 7, "size": 8192,
                               "h": inner})
        a_sock.sendall(b"".join(bytes(c) for c in rts))
        cts_h, _ = pp.decode_frame(pp.read_frame(a_sock))
        assert cts_h["t"] == pp.CTS and cts_h["x"] == 7
        _wait(lambda: (0, 7) in port._inx, msg="assembly registered")
        data = pp.encode_frame({"t": pp.DATA, "src": 0, "dst": 1, "x": 7, "o": 0, "n": 4096})
        a_sock.sendall(b"".join(bytes(c) for c in data) + b"\x00" * 4096)
        a_sock.close()
        hooks.wait_closed()
        assert hooks.frames == []
        _wait(lambda: not port._inx, msg="assembly discard")
    finally:
        a_sock.close()
        port.close()


def _build_multi(pp, src, dst, parts):
    header = {"t": pp.MULTI, "src": src, "dst": dst, "n": len(parts)}
    hdr = pp._encode_header(header)
    inner = sum(pp._chunks_nbytes(p) for p in parts)
    prefix = bytearray(8)
    pp._U32.pack_into(prefix, 0, 4 + len(hdr) + inner)
    pp._U32.pack_into(prefix, 4, len(hdr))
    chunks = [b"".join((prefix, hdr))]
    for part in parts:
        chunks.extend(part)
    wire = memoryview(b"".join(bytes(c) for c in chunks))
    return header, wire[8 + len(hdr):]


@pytest.mark.parametrize("pkg", PKGS)
def test_iter_multi_walks_every_subframe(pkg):
    pp = PKGS[pkg]
    parts = [pp.encode_frame(_parcel_header(pp, 0, 1, i + 1), ((i,), {})) for i in range(3)]
    header, rest = _build_multi(pp, 0, 1, parts)
    subs = list(pp.iter_multi(header, rest))
    assert len(subs) == 3
    for i, (shdr, _hb, srest, wire) in enumerate(subs):
        assert shdr["seq"] == i + 1 and pp.decode_payload(shdr, srest)[0] == (i,)
        assert wire == pp._chunks_nbytes(parts[i])


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_parcel_headers_covers_all_carriers(pkg):
    pp = PKGS[pkg]
    parts = [pp.encode_frame(_parcel_header(pp, 0, 2, i + 1), ((i,), {})) for i in range(2)]
    mh, mrest = _build_multi(pp, 0, 2, parts)
    assert [h["seq"] for h in pp.failed_parcel_headers(
        pp.Frame(mh, b"", mrest, mrest.nbytes + 8, 0))] == [1, 2]
    plain = pp.Frame(_parcel_header(pp, 0, 2, 9), b"", memoryview(b""), 0, 0)
    assert [h["seq"] for h in pp.failed_parcel_headers(plain)] == [9]
    rts = pp.Frame({"t": pp.RTS, "src": 0, "dst": 2, "x": 1, "size": 10,
                    "h": _parcel_header(pp, 0, 2, 5)}, b"", memoryview(b""), 0, 0)
    assert [h["seq"] for h in pp.failed_parcel_headers(rts)] == [5]
    cred = pp.Frame({"t": pp.CREDIT, "src": 0, "dst": 2, "n": 4}, b"", memoryview(b""), 0, 0)
    assert list(pp.failed_parcel_headers(cred)) == []


def test_net_config_from_env_matches_reference(monkeypatch):
    monkeypatch.setenv("REPRO_NET_STRIPES", "3")
    monkeypatch.setenv("REPRO_NET_COALESCE_WINDOW_US", "75.5")
    assert tpp.NetConfig.from_env().__dict__ == rpp.NetConfig.from_env().__dict__
    assert tpp.NetConfig.from_env().stripes == 3


# ------------------------------------------------- real-fleet failure modes
@pytest.fixture()
def port_fleet():
    """Leak-proof port fleets for one test: every runtime made through the
    factory is shut down (workers reaped) even when the test fails."""
    import contextlib

    import repro_torch.core as tcore
    from repro_torch import net as tnet

    tcore.init(num_workers=4)
    try:
        with contextlib.ExitStack() as stack:
            yield lambda n, **kw: stack.enter_context(tnet.running(n, **kw))
    finally:
        tcore.finalize()


def test_pending_promise_fails_with_portclosed_on_peer_death(port_fleet):
    from repro_torch.net import remote

    net = port_fleet(2, pools={"default": 2, "io": 1})
    big = torch.zeros(8 << 20, dtype=torch.uint8)  # forces the rendezvous tier
    fut = net.send_parcel(1, remote._slow_sink._action_name, None, (big, 30.0))
    net._procs[1].terminate()
    with pytest.raises(tpp.PortClosed):
        fut.get(timeout=30)
    _wait(lambda: not net._port._outx, msg="out-transfer cleanup")
    _wait(lambda: not any(k[0] == 1 for k in net._port._inx), msg="assembly cleanup")


def test_down_broadcast_fails_worker_to_worker_pending(port_fleet):
    from repro_torch import net as tnet

    net = port_fleet(3, pools={"default": 2, "io": 1})
    outer = tnet.run_on(1, call_slow_peer, 2)
    time.sleep(1.0)
    net._procs[2].terminate()
    assert outer.get(timeout=60) == "portclosed"


def test_backpressure_releases_after_drain(port_fleet):
    from repro_torch import net as tnet
    from repro_torch.net import remote

    cfg = tnet.NetConfig(send_budget=64 * 1024)
    net = port_fleet(2, pools={"default": 2, "io": 2}, config=cfg)
    ch = net._conns[1]
    blocked0, deferred0 = ch.c_blocked.get_value(), ch.c_deferred.get_value()
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(ch.inflight_bytes(1))
            time.sleep(0.0005)

    sampler = threading.Thread(target=sample, name="sampler")
    sampler.start()
    try:
        for _ in range(80):
            net.send_parcel(1, remote._slow_sink._action_name, None,
                            (torch.zeros(8192, dtype=torch.uint8), 0.002),
                            want_result=False)
    finally:
        stop.set()
        sampler.join(timeout=5.0)
    engaged = (ch.c_blocked.get_value() - blocked0) + (ch.c_deferred.get_value() - deferred0)
    assert engaged > 0 and max(samples) <= cfg.send_budget
    _wait(lambda: ch.inflight_bytes(1) == 0, timeout=30.0, msg="post-flood drain")
    assert tnet.run_on(1, echo_len, b"abc").get(timeout=30) == 3
