"""The port's engine-replica router (``repro_torch.serving.router``)
against the reference's.

* All seven tests of ``tests/test_serving_router.py`` replayed on port
  engines: the module's engine, request, sampling and router names
  swapped for the port's (prefix-key granularity, least-loaded
  alternation, affinity that sticks then spills, routed ≡ solo, failure
  requeue and replay, the last replica's failure, the stats' shape).
* Placements decision for decision: one submit sequence (shared
  block-aligned prefixes, distinct prompts, a spill, a replica failure)
  through a reference router over reference engines and a port router
  over port engines in lockstep: every request's replica, the affinity
  hits and requeues after every step, and the streams, are equal.
* One router over two engines each sharded over a 2-rank mesh (gloo on
  the CPU) ≡ every request's solo one-device run, with and without a
  replica failure part-way.
"""
import dataclasses
import inspect

import jax
import numpy as np
import pytest

import test_serving_router as ref_router_tests
import test_torch_ranks as R
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving.router import ReplicaRouter as JaxRouter
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.serving import (AFFINITY_SLACK_SLOTS, ReplicaRouter,
                                 Request, SamplingParams, ServingEngine,
                                 prefix_key)
from repro_torch.serving import router as port_router
from test_serving_fuzz import BLOCK, CFG, CHUNK, MAX_LEN, SLOTS

GEO = dict(slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK, block=BLOCK)
RANK_TIMEOUT = 120.0

REF_TESTS = sorted(n for n, f in vars(ref_router_tests).items()
                   if n.startswith("test_") and callable(f))


@pytest.fixture(scope="module")
def weights():
    jm = JaxModel(CFG)
    jp = jm.init(jax.random.key(0))
    return jm, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def port_model(weights):
    return R.build_model(dataclasses.asdict(CFG), weights[2])


def test_reference_router_has_seven_tests():
    assert len(REF_TESTS) == 7


@pytest.mark.parametrize("name", REF_TESTS)
def test_reference_router_case_on_port(name, port_model, monkeypatch):
    for attr, value in {"ServingEngine": ServingEngine, "Request": Request,
                        "SamplingParams": SamplingParams,
                        "ReplicaRouter": ReplicaRouter,
                        "prefix_key": prefix_key}.items():
        monkeypatch.setattr(ref_router_tests, attr, value)
    fn = getattr(ref_router_tests, name)
    if inspect.signature(fn).parameters:
        fn(port_model)
    else:
        fn()


def test_router_constants_and_keys_equal_reference():
    from repro.serving import router as jax_router
    assert AFFINITY_SLACK_SLOTS == jax_router.AFFINITY_SLACK_SLOTS
    rng = np.random.default_rng(9)
    for n in (3, BLOCK, BLOCK + 3, 3 * BLOCK + 1):
        p = rng.integers(0, CFG.vocab, n).astype(np.int32)
        assert port_router.prefix_key(p, BLOCK) == \
            jax_router.prefix_key(p, BLOCK)


def _requests(seed: int, n: int = 10) -> list:
    """A submit sequence: two shared two-block prefixes with short tails
    (affinity, then a spill past the slack), distinct sub-block prompts
    and a few seeded sampled requests."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, CFG.vocab, 2 * BLOCK) for _ in range(2)]
    out = []
    for rid in range(n):
        if rid % 3 == 2:
            prompt = rng.integers(0, CFG.vocab, int(rng.integers(3, BLOCK)))
        else:
            tail = rng.integers(0, CFG.vocab, int(rng.integers(1, 4)))
            prompt = np.concatenate([bases[rid % 2], tail])
        sampling = None
        if rid % 4 == 3:
            sampling = dict(temperature=0.8, top_k=12, top_p=1.0,
                            seed=100 + rid)
        out.append((rid, prompt.astype(np.int32).tolist(),
                    int(rng.integers(2, 6)), sampling))
    return out


def _ref_router(jm, jp):
    return JaxRouter([ref_router_tests.make_engine(jm, jp)
                      for _ in range(2)])


@pytest.mark.parametrize("fail_at", [None, 3], ids=["steady", "failover"])
@pytest.mark.parametrize("seed", [0, 1])
def test_placements_equal_reference_router(weights, port_model, seed,
                                           fail_at):
    jm, jp, _ = weights
    model, params = port_model
    routers = (_ref_router(jm, jp),
               ReplicaRouter([R.router_engine(model, params, GEO)
                              for _ in range(2)]))
    reqs = []
    for Req, SP in ((JaxRequest, JaxSamplingParams),
                    (Request, SamplingParams)):
        reqs.append([Req(rid=rid, prompt=np.array(p, np.int32),
                         max_new_tokens=m,
                         sampling=SP(**s) if s is not None else None)
                     for rid, p, m, s in _requests(seed)])
    for router, rs in zip(routers, reqs):
        for r in rs:
            router.submit(r)

    def state(router):
        return ({rid: pl.replica for rid, pl in router.placements.items()},
                router.affinity_hits, router.requeued, router.dispatched,
                dict(router.affinity), list(router.alive))
    steps = 0
    while any(r.pending() for r in routers) and steps < 500:
        if steps == fail_at:
            moved = [r.fail_replica(1) for r in routers]
            assert moved[0] == moved[1]
        for r in routers:
            r.step()
        assert state(routers[1]) == state(routers[0])
        steps += 1
    assert routers[0].affinity_hits > 0
    assert [r.generated for r in reqs[1]] == [r.generated for r in reqs[0]]
    if fail_at is not None:
        assert routers[1].requeued == routers[0].requeued > 0


def _solo(model, params, request) -> list:
    eng = R.router_engine(model, params, GEO)
    req = R.make_request(*request)
    eng.submit(req)
    eng.run()
    return list(req.generated)


@pytest.fixture(scope="module")
def sharded_routes(weights, tmp_path_factory):
    requests = _requests(2)
    return requests, spawn_ranks(
        R.router_rank, 2,
        args=(dataclasses.asdict(CFG), weights[2], GEO, requests, (None, 3)),
        devices=["cpu", "cpu"], timeout_s=RANK_TIMEOUT,
        store_dir=tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("scenario", [0, 1], ids=["steady", "failover"])
def test_router_over_sharded_engines_equals_solo(port_model, sharded_routes,
                                                 scenario):
    """Two replicas, each a 2-rank concat-TP engine, behind one router:
    every stream equals the request's solo one-device run, both ranks
    agree, and the unsharded router places the requests the same way."""
    model, params = port_model
    requests, ranks = sharded_routes
    streams, first, counters = ranks[0][scenario]
    assert ranks[1][scenario] == ranks[0][scenario]
    assert streams == [_solo(model, params, r) for r in requests]
    assert counters["affinity_hits"] > 0
    assert set(first.values()) == {0, 1}
    solo_router = ReplicaRouter([R.router_engine(model, params, GEO)
                                 for _ in range(2)])
    assert R.route(solo_router, requests, (None, 3)[scenario]) == \
        ranks[0][scenario]
    if scenario:
        assert counters["requeued"] > 0 and counters["live_replicas"] == 1
