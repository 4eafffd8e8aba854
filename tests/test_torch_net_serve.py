"""Serving across localities in the port (``tests/test_net_serve.py``'s
cases): ``Router.over_localities`` places one engine per OS process, the
token relay carries streams home, sampling params cross the wire; and the
pieces live migration is built from, each against the reference:

- the relay (``serve/relay.py``) fed the same scripted interleavings
  (duplicate, out-of-order, dropped then backfilled, orphaned, failed,
  aborted, re-homed) in both packages: the same streams, outcomes and
  counters;
- a paged slot's snapshot (``PagedKVCache.snapshot_slot``) equal to the
  reference's over the same pages, and after ``restore_slot`` into a
  second pool (through the wire codec) the next decode's logits equal
  the unmoved slot's;
- the port's engine, given the reference's params by ``from_reference``,
  yields the reference engine's greedy tokens, so the remote engines'
  tokens (equal to the local one's) are the reference's rule.

Smoke starcoder2_3b in fp32 on the CPU; every ``get`` carries a timeout."""

import re
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch import net as tnet
from repro_torch.core import counters as tcounters
from repro_torch.core.future import Channel
from repro_torch.serve.engine import SamplingParams, ServeConfig
from repro_torch.serve.router import RemoteEngine, Router

ARCH = "starcoder2_3b"
POOLS = {"default": 4, "prefill": 2, "io": 1}


@pytest.fixture(scope="module")
def net_router():
    tcore.init(pools=POOLS)
    try:
        with tnet.running(2, pools=POOLS, worker_pools=POOLS) as net:
            scfg = ServeConfig(max_batch=2, cache_len=64, max_new_tokens=6)
            router = Router.over_localities(net, ARCH, scfg, smoke=True, device="cpu",
                                            dtype="float32")
            try:
                yield net, router
            finally:
                router.engines[0].close()
    finally:
        tcore.finalize()


def _total(name):
    return sum(v for _, v in tcounters.query(name))


def test_both_localities_serve(net_router):
    net, router = net_router
    assert isinstance(router.engines[1], RemoteEngine) and router.engines[1].locality == 1
    assert router.spec == {"arch": ARCH, "smoke": True, "device": "cpu", "dtype": "float32",
                           "scfg_kwargs": router.spec["scfg_kwargs"]}
    rng = np.random.default_rng(0)
    futures = [router.submit(rng.integers(1, 512, size=rng.integers(4, 20)).tolist())
               for _ in range(8)]
    outs = [f.get(timeout=120) for f in futures]
    assert all(len(o) == 7 for o in outs)  # max_new + prefill token
    assert _total("/serve{engine#0}/tokens/generated") > 0, "locality 0 must serve"
    remote = dict(tnet.query_counters(1, "/serve{engine#1}/tokens/generated"))
    assert sum(remote.values()) > 0, "locality 1 must serve"
    assert router.engines[1]._gossip >= 0.0 and router.engines[1]._inflight == 0
    assert 0.0 <= router.engines[1].occupancy() <= 1.0


def test_remote_greedy_matches_local_engine(net_router):
    """Replicas build identical params from the shared seed: a greedy
    prompt decodes identically on either locality."""
    net, router = net_router
    prompt = list(range(1, 11))
    local = router.engines[0].submit(prompt).get(timeout=120)
    remote = router.engines[1].submit(prompt).get(timeout=120)
    assert local == remote


def test_streaming_crosses_localities_via_relay(net_router):
    net, router = net_router
    ch, fut = router.submit_stream(list(range(1, 8)))
    toks = list(ch)
    assert toks == fut.get(timeout=120)
    dups = _total("/serve{relay}/tokens/duplicates")
    ch2 = Channel()
    fut2 = router.engines[1].submit(list(range(1, 8)), stream=ch2)
    toks2 = list(ch2)
    assert toks2 == fut2.get(timeout=120) == toks
    assert _total("/serve{relay}/tokens/duplicates") == dups


def test_remote_sampling_params_cross_the_wire(net_router):
    net, router = net_router
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
    out = router.engines[1].submit(list(range(1, 9)), sampling=sp).get(timeout=120)
    assert len(out) == 7 and all(0 <= t < 49152 for t in out)


def test_engine_submit_one_shot_action(net_router):
    """``_engine_submit``, the blocking one-shot spelling, by GID."""
    from repro_torch.serve.router import _engine_submit

    net, router = net_router
    e1 = router.engines[1]
    tokens, load = tnet.apply_remote(_engine_submit, e1.gid, list(range(1, 11)), None,
                                     None).get(timeout=120)
    assert tokens == router.engines[0].submit(list(range(1, 11))).get(timeout=120)
    assert load == 0.0


def test_local_engine_with_reference_params_matches_reference_engine(rt):
    """The recipe every locality runs, fed the reference's params, gives
    the reference engine's greedy tokens."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.dist.plan import get_plan
    from repro.models.model import build_model as ref_build
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import ServeConfig as RServeConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_reference
    from repro_torch.serve.engine import Engine

    rcfg = replace(ref_config(ARCH, smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, get_plan("serve"))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    cfg = replace(get_config(ARCH, smoke=True), dtype="float32")
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    kw = dict(max_batch=2, cache_len=64, max_new_tokens=6, name="engine#ref-parity")
    prompts = [list(range(1, 11)), [7, 3, 9], [100, 200, 300, 400, 5]]
    ref = REngine(rmodel, rparams, RServeConfig(**kw))
    want = [f.get(timeout=300) for f in [ref.submit(p) for p in prompts]]
    tcore.init(pools=POOLS)
    try:
        eng = Engine(model, params, ServeConfig(**kw), device="cpu")
        got = [f.get(timeout=120) for f in [eng.submit(p) for p in prompts]]
        eng.close()
    finally:
        tcore.finalize()
    assert got == want


# ------------------------------------------------------------------ relay
class _StubNet:
    """What ``open_sink`` needs of a runtime: the peer-down hook list."""

    def __init__(self):
        self.hooks = []

    def add_peer_down_hook(self, cb):
        self.hooks.append(cb)


class _Err(RuntimeError):
    pass


RELAY_SCRIPTS = {
    "in_order": [("tok", 0, 11), ("tok", 1, 12), ("tok", 2, 13), ("done", [11, 12, 13])],
    "duplicate": [("tok", 0, 11), ("tok", 0, 11), ("tok", 1, 12), ("tok", 1, 12),
                  ("done", [11, 12])],
    "out_of_order": [("tok", 2, 13), ("tok", 1, 12), ("tok", 0, 11), ("tok", 3, 14),
                     ("done", [11, 12, 13, 14])],
    "dropped_then_backfilled": [("tok", 0, 11), ("tok", 2, 13), ("done", [11, 12, 13, 14])],
    "orphaned": [("tok", 0, 11), ("done", [11, 12]), ("tok", 1, 12)],
    "failed_after_tokens": [("tok", 0, 11), ("tok", 1, 12), ("fail",)],
    "failed_before_tokens": [("fail",)],
    "aborted_after_tokens": [("tok", 0, 11), ("abort",), ("tok", 1, 12)],
    "aborted_before_tokens": [("abort",)],
    "peer_down": [("tok", 0, 11), ("peer_down", 1), ("done", [11, 12])],
    "rehomed_then_old_peer_down": [("tok", 0, 11), ("rehome", 1, 2), ("peer_down", 1),
                                   ("tok", 1, 12), ("done", [11, 12])],
}


def _run_relay(pkg, script):
    if pkg == "port":
        from repro_torch.core.future import Channel as Ch
        from repro_torch.serve import relay
        from repro_torch.core import counters as C
    else:
        from repro.core.future import Channel as Ch
        from repro.serve import relay
        from repro.core import counters as C
    names = ["delivered", "duplicates", "out_of_order", "backfilled", "orphaned"]
    streams = ["opened", "closed", "aborted"]

    def snap():
        return ([C.default().counter(f"/serve{{relay}}/tokens/{n}").get_value() for n in names]
                + [C.default().counter(f"/serve{{relay}}/streams/{n}").get_value()
                   for n in streams])

    before = snap()
    net = _StubNet()
    ch = Ch()
    results = []
    sid = relay.open_sink(net, ch, 1, lambda ok, payload, gossip: results.append(
        (ok, type(payload).__name__,
         payload if ok else re.sub(r"stream \d+", "stream S", str(payload)), gossip)))
    aborted = []
    for ev in script:
        if ev[0] == "tok":
            relay._deliver_token(None, sid, ev[1], ev[2])
        elif ev[0] == "done":
            relay._deliver_done(None, sid, True, list(ev[1]), {"load": 1.0, "occ": 0.5})
        elif ev[0] == "fail":
            relay._deliver_done(None, sid, False, _Err("engine failed"), None)
        elif ev[0] == "abort":
            aborted.append(relay.abort(sid, _Err("gone")))
        elif ev[0] == "peer_down":
            aborted.append(relay.abort_for_peer(ev[1]))
        elif ev[0] == "rehome":
            aborted.append(relay.rehome_streams(ev[1], ev[2]))
    got = []
    while True:
        ok, v = ch.try_get()
        if not ok:
            break
        got.append(v)
    closed = ch.is_closed()
    end = type(ch._close_exc).__name__ if closed and ch._close_exc is not None else None
    relay.abort(sid, _Err("cleanup"))  # no-op unless the script left it open
    delta = [a - b for a, b in zip(snap(), before)]
    return got, closed, end, results[:1], aborted, delta, sid in relay.live_sids()


@pytest.mark.parametrize("script", list(RELAY_SCRIPTS))
def test_relay_interleavings_match_reference(script):
    out = {pkg: _run_relay(pkg, RELAY_SCRIPTS[script]) for pkg in ("ref", "port")}
    assert out["port"] == out["ref"]
    got, closed, end, results, _aborted, delta, live = out["port"]
    assert not live
    if script in ("in_order", "duplicate", "out_of_order", "dropped_then_backfilled",
                  "orphaned"):
        assert closed and end is None and results[0][0] is True and got == results[0][2]
    if script == "duplicate":
        assert delta[1] == 2
    if script == "dropped_then_backfilled":
        assert delta[3] == 2 and got == [11, 12, 13, 14]
    if script == "orphaned":
        assert delta[4] == 1
    if script in ("failed_after_tokens", "aborted_after_tokens", "peer_down"):
        assert end == "StreamBroken"
    if script in ("failed_before_tokens", "aborted_before_tokens"):
        assert not closed  # the router may re-dispatch into the open channel


def test_token_relay_numbers_from_its_start_index():
    """A migrated request's relay continues the source's numbering; a
    non-streaming relay only counts."""
    from repro.serve.relay import TokenRelay as RRelay
    from repro_torch.serve.relay import TokenRelay

    for cls in (RRelay, TokenRelay):
        r = cls(client=0, sid=5, idx=7, stream=False)
        r.set(1)
        r.set(2)
        r.close()
        assert (r.client, r.sid, r.idx, r.stream) == (0, 5, 9, False)


# --------------------------------------------------------------- KV slots
def _kv_models():
    import jax

    from repro.configs import get_config as ref_config
    from repro.dist.plan import get_plan
    from repro.models.model import build_model as ref_build
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_reference

    rcfg = replace(ref_config(ARCH, smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, get_plan("serve"))
    rparams = rmodel.init(jax.random.PRNGKey(2))
    cfg = replace(get_config(ARCH, smoke=True), dtype="float32")
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    return rmodel, rparams, model, params


def test_slot_snapshot_and_restore_match_reference(rt):
    import jax.numpy as jnp

    from repro.serve.kv_cache import PagedKVCache as RCache
    from repro_torch.net import parcelport as tpp
    from repro_torch.serve.kv_cache import PagedKVCache

    rmodel, rparams, model, params = _kv_models()
    n, bucket = 37, 64
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :n] = np.random.default_rng(3).integers(1, 500, size=n)
    dims = dict(num_pages=12, page_size=16, max_batch=2, max_pages_per_req=4)

    _, rc = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks, jnp.int32)}, cache_len=bucket,
                           valid_len=jnp.asarray([n], jnp.int32))
    rkv = RCache(rmodel, name="kvtest-ref", **dims)
    assert rkv.admit(1, rc, n)
    rsnap = rkv.snapshot_slot(1)
    with torch.inference_mode():
        _, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache_len=bucket,
                              valid_len=torch.tensor([n], dtype=torch.int32))
    tkv = PagedKVCache(model, name="kvtest-port", **dims)
    assert tkv.admit(1, tc, n)
    own = tkv.snapshot_slot(1)
    assert own["pos"] == rsnap["pos"] == n and own["n_pages"] == rsnap["n_pages"] == 3
    assert np.array_equal(tkv.page_table, rkv.page_table)
    for k in rsnap["pages"]:  # the port's own prefill KV, held against the reference's
        np.testing.assert_allclose(own["pages"][k].numpy(), rsnap["pages"][k],
                                   rtol=1e-4, atol=1e-4)
    # the same converted pages: the snapshot is the reference's, exactly
    ids = torch.as_tensor(tkv._owned[1])
    for k, pool in tkv.pools.items():
        pool[:, ids] = torch.from_numpy(np.array(rsnap["pages"][k]))
    snap = tkv.snapshot_slot(1)
    for k in rsnap["pages"]:
        assert snap["pages"][k].dtype == torch.float32
        assert np.array_equal(snap["pages"][k].numpy(), np.asarray(rsnap["pages"][k]))

    # through the wire codec, into a second pool whose free list differs
    wire = bytearray(b"".join(bytes(c) for c in tpp.encode_frame(
        {"t": tpp.RESULT, "src": 1, "dst": 0, "seq": 1}, snap)))  # as a lane receives it
    hdr, rest = tpp.decode_frame(memoryview(wire[4:]))
    shipped = tpp.decode_payload(hdr, rest)
    tkv2 = PagedKVCache(model, name="kvtest-port2", **dims)
    assert tkv2.admit(0, tc, 20)  # two pages taken first: other page ids
    free = tkv2.free_pages()
    assert tkv2.restore_slot(1, shipped)
    assert tkv2.free_pages() == free - 3 and tkv2.pos[1] == n
    assert tkv2._owned[1] != tkv._owned[1]  # the same K/V in other pages
    back = tkv2.snapshot_slot(1)
    for k in snap["pages"]:
        assert torch.equal(back["pages"][k], snap["pages"][k])
    # the next decode reads the same K/V from other pages: the same logits
    token = torch.tensor([[17], [17]])
    with torch.inference_mode():
        a, _ = model.decode_paged(params, tkv.device_cache(), token)
        b, _ = model.decode_paged(params, tkv2.device_cache(), token)
    assert torch.equal(a[1], b[1])
    # a pool that cannot hold the slot says so and keeps its pages
    small = PagedKVCache(model, name="kvtest-small", num_pages=3, page_size=16, max_batch=2,
                         max_pages_per_req=4)
    assert not small.restore_slot(1, shipped) and small.free_pages() == 2
    with pytest.raises(RuntimeError, match="still owns pages"):
        tkv2.restore_slot(1, shipped)
    for kv in (tkv, tkv2, small):
        kv.close()
