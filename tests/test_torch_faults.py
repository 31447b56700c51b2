"""Port parity — fault injection, quarantine, the trie checksums, the retry
budget and ``ReplicaSet`` (repro_torch vs repro), on the CPU with the
reduced gemma-2b at f32, the reference's weights bridged across.

``tests/test_faults.py``'s classes are mirrored: each scenario runs on both
packages with the same specs on a ``VirtualClock``, and the ``fired`` logs,
the ``Finished`` reasons, the stats, the tokens and the replicas' health
transitions must be equal. Two replicas run on ``devices=["cpu", "cpu"]``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge, pool_from_jax, ref_engine

import repro.serve as J
import repro_torch.serve as P
from repro import configs as jconfigs
from repro.launch import serve as JL
from repro.models import transformer as JT
from repro.quant import PrecisionPlan as JPlan
from repro.serve import faults as JF
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as PL
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.serve import faults as PF

HEALTH = dict(step_deadline_s=1.0, dead_after=2, restart_backoff_s=0.1,
              backoff_cap_s=0.5, max_restarts=2)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jnp.float32)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=torch.float32)
    params = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0))
    return {"j": (jcfg, params, J, JF, JPlan, {}),
            "t": (tcfg, bridge(params), P, PF, TPlan, {"device": "cpu"})}


def _engine(side, *, kv_bits=8, **kw):
    cfg, params, S, _, Plan, dkw = side
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_seq_len", 32)
    kw.setdefault("clock", S.VirtualClock())
    if S is J:
        return ref_engine(params, cfg, plan=Plan(kv_bits=kv_bits), backend="ref", **kw)
    return S.ServeEngine(params, cfg, plan=Plan(kv_bits=kv_bits), **dkw, **kw)


def _reqs(S, n, *, prompt_len=6, gen=4, seed=0):
    rng = np.random.default_rng(seed)
    return [S.Request(rid=i, prompt=rng.integers(0, 512, prompt_len), max_new_tokens=gen)
            for i in range(n)]


def _out(res):
    return {rid: (f.tokens.tolist(), f.prompt_len, f.n_generated, f.reason)
            for rid, f in res.items()}


def _fired(inj):
    return [(r["kind"], r["step"], r["replica"], r["t"], dataclasses.astuple(r["spec"]))
            for r in inj.fired]


def _both(model, scenario):
    """Run ``scenario(side)`` on each package; return (port, reference).
    A scenario's checks of a run against a clean run of the same package
    run on the port's side alone (the reference's own tests hold them
    there): each reference engine compiles its programs anew."""
    return scenario(model["t"]), scenario(model["j"])


# ---------------------------------------------------------- the injector
@pytest.mark.parametrize("kw", [dict(kind="meteor_strike", at_step=1),
                                dict(kind="replica_raise", at_step=-1)])
def test_spec_validation_same_error(kw):
    errs = []
    for F in (PF, JF):
        with pytest.raises(ValueError) as e:
            F.FaultSpec(**kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_injector_fires_once_with_the_same_log():
    def run(F):
        clock = F.VirtualClock()
        inj = F.FaultInjector([F.FaultSpec("nan_logits", at_step=3, rid=7),
                               dict(kind="replica_raise", at_step=2, replica=1)],
                              clock=clock)
        log = [inj.poll("nan_logits", step=2)]
        clock.advance(1.5)
        log += [[sp.rid for sp in inj.poll("nan_logits", step=3)], inj.n_armed,
                inj.poll("nan_logits", step=3), inj.poll("replica_raise", step=5, replica=0),
                len(inj.poll("replica_raise", step=5, replica=1)), inj.n_armed]
        with pytest.raises(ValueError, match="forward"):
            clock.advance(-0.1)
        return log, _fired(inj), clock()
    assert run(PF) == run(JF)


def test_flip_bits_and_corrupt_kv_page_equal(model):
    for dt in (np.float32, np.int8, np.uint8):
        a = np.arange(64).astype(dt)
        np.testing.assert_array_equal(PF.flip_bits(a, 5, seed=9), JF.flip_bits(a, 5, seed=9))
    for kv_bits in (0, 8, 4):
        jpool = J.pages.init_pool(2, 6, 4, 1, 16, kv_bits=kv_bits)
        rng = np.random.default_rng(kv_bits)
        jpool = jpool._replace(k_pages=jnp.asarray(
            rng.integers(0, 100, jpool.k_pages.shape)).astype(jpool.k_pages.dtype))
        tpool = pool_from_jax(jpool)
        got = PF.corrupt_kv_page(tpool, 3, n_flips=6, seed=11)
        want = JF.corrupt_kv_page(jpool, 3, n_flips=6, seed=11)
        assert got is tpool
        np.testing.assert_array_equal(got.k_pages.view(torch.uint8).numpy() if kv_bits == 0
                                      else got.k_pages.numpy(),
                                      np.asarray(want.k_pages).view(np.uint8) if kv_bits == 0
                                      else np.asarray(want.k_pages))


# ------------------------------------------------------------ quarantine
def test_injected_nan_fails_one_request_like_reference(model):
    def scenario(side):
        S, F = side[2], side[3]
        inj = F.FaultInjector([F.FaultSpec("nan_logits", at_step=4, rid=1)])
        eng = _engine(side, fault_injector=inj)
        out = eng.run(_reqs(S, 4, gen=8))
        assert out[1].reason == "nan" and eng.stats["quarantined"] == 1
        if S is P:
            clean = _engine(side).run(_reqs(S, 4, gen=8))
            for rid in (0, 2, 3):
                np.testing.assert_array_equal(clean[rid].tokens, out[rid].tokens)
        eng.allocator.check_leaks(0)
        return _out(out), _fired(inj), eng.stats["quarantined"], eng.stats["finished"]
    got, want = _both(model, scenario)
    assert got == want


def test_real_nan_kv_quarantined_and_scrubbed_like_reference(model):
    """NaNs written into one active slot's first page at raw KV trip the
    per-slot finiteness check; its freed pages are scrubbed."""
    def scenario(side):
        S = side[2]
        eng = _engine(side, kv_bits=0)
        for r in _reqs(S, 4, gen=6):
            eng.submit(r)
        done, poisoned = {}, None
        for _ in range(60):
            if poisoned is None and eng.n_active >= 2:
                slot = int(np.flatnonzero(eng._active)[0])
                poisoned = eng._slots[slot]["req"].rid
                page = int(eng._slots[slot]["pages"][0])
                if S is J:
                    eng.pool = eng.pool._replace(
                        k_pages=eng.pool.k_pages.at[:, page].set(jnp.nan))
                else:
                    eng.pool.k_pages[:, page] = float("nan")
            done.update({f.rid: f for f in eng.step()})
            if not eng.busy:
                break
        assert done[poisoned].reason == "nan" and eng.stats["quarantined"] == 1
        eng.allocator.check_leaks(0)
        assert bool(np.isfinite(np.asarray(eng.pool.k_pages)).all())
        return poisoned, _out(done)
    got, want = _both(model, scenario)
    assert got == want


def test_kv_flip_fault_like_reference(model):
    def scenario(side):
        S, F = side[2], side[3]
        inj = F.FaultInjector([F.FaultSpec("kv_flip", at_step=3, n_flips=2, seed=5)])
        eng = _engine(side, fault_injector=inj)
        out = eng.run(_reqs(S, 3))
        assert eng.stats["kv_flips"] == 1 and inj.n_armed == 0
        eng.allocator.check_leaks(0)
        return _out(out), _fired(inj)
    got, want = _both(model, scenario)
    assert got == want


# --------------------------------------------------------- trie checksum
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_corrupt_shared_page_evicted_like_reference(model, kv_bits):
    def scenario(side):
        S, F = side[2], side[3]
        rng = np.random.default_rng(3)
        sys_prompt = rng.integers(0, 512, 8)
        suffixes = [rng.integers(0, 512, 3) for _ in range(3)]

        def wave():
            return [S.Request(rid=i, prompt=np.concatenate([sys_prompt, suffixes[i]]),
                              max_new_tokens=4) for i in range(3)]

        warm = _engine(side, kv_bits=kv_bits, prefix_cache=True, chunk_pages=1)
        warm.run(wave())
        victim = warm.prefix.match(np.asarray(wave()[0].prompt, np.int32))[0]
        got = F.corrupt_kv_page(warm.pool, victim, n_flips=3, seed=11)
        if S is J:
            warm.pool = got
        out = warm.run(wave())
        assert warm.prefix.corrupt_evictions >= 1
        if S is P:
            cold = _engine(side, kv_bits=kv_bits, chunk_pages=1).run(wave())
            assert _out(out) == _out(cold)
        assert warm.release_prefix_cache() >= 1
        warm.allocator.check_leaks(0)
        return _out(out), warm.prefix.corrupt_evictions, warm.stats["prefix_hits"]
    got, want = _both(model, scenario)
    assert got == want


def test_checksums_stamped_on_insert(model):
    eng = _engine(model["t"], prefix_cache=True, chunk_pages=1)
    eng.run(_reqs(P, 2, prompt_len=9, seed=4))
    nodes = list(eng.prefix._root.children.values())
    assert nodes
    while nodes:
        n = nodes.pop()
        assert n.checksum == eng._page_checksum(n.page)
        nodes.extend(n.children.values())
    eng.release_prefix_cache()
    eng.allocator.check_leaks(0)


# ---------------------------------------------------------- retry budget
@pytest.mark.parametrize("budget", [2, 3])
def test_retry_budget_like_reference(model, budget):
    def scenario(side):
        S = side[2]
        eng = _engine(side, retry_budget=budget)
        req = _reqs(S, 1)[0]
        eng.submit_entry({"req": req, "prompt": np.asarray(req.prompt, np.int32),
                          "t_submit": 0.0, "retries": 3})
        out = eng.run()
        return _out(out), eng.stats["retries_exhausted"]
    got, want = _both(model, scenario)
    assert got == want
    assert got[1] == int(budget < 3)
    with pytest.raises(ValueError, match="retry_budget"):
        _engine(model["t"], retry_budget=0)


# ------------------------------------------------------------ ReplicaSet
def _replica_set(side, n=2, *, faults=None, health=None, factory=None, ship_dir=None):
    S, L = side[2], (JL if side[2] is J else PL)
    clock = S.VirtualClock()
    if faults is not None:
        faults.clock = clock

    def default_factory(i):
        return _engine(side, clock=clock, fault_injector=faults, replica_id=i)

    kw = {} if S is J else {"devices": ["cpu"] * n}
    rs = L.ReplicaSet(factory or default_factory, n, clock=clock, fault_injector=faults,
                      health=health or L.HealthConfig(**HEALTH), ship_dir=ship_dir, **kw)
    return rs, clock


def _settle(rs, clock, max_steps=200):
    for _ in range(max_steps):
        if all(h.state in ("healthy", "failed") for h in rs.health):
            return
        clock.advance(0.05)
        rs.step()
    raise AssertionError("health machine did not settle")


def _drain(rs, clock, reqs=(), max_steps=500):
    for r in reqs:
        rs.submit(r)
    out = {}
    for _ in range(max_steps):
        if not rs._queue and not any(e.busy for e in rs.engines):
            return out
        for rid, f in rs.step().items():
            assert rid not in out, f"request {rid} finished twice"
            out[rid] = f
        clock.advance(0.01)
    raise AssertionError("drain did not converge")


def _rs_state(rs, out):
    return (_out(out), dict(rs.stats), list(rs.dispatched),
            [(h.state, h.restarts, h.transitions) for h in rs.health])


def test_stall_suspect_then_recover_like_reference(model):
    def scenario(side):
        S, F = side[2], side[3]
        faults = F.FaultInjector([F.FaultSpec("replica_stall", at_step=3, replica=0,
                                              stall_s=5.0)])
        rs, clock = _replica_set(side, faults=faults)
        out = _drain(rs, clock, _reqs(S, 6))
        assert rs.stats["step_failures"] == 1 and rs.health[0].state == "healthy"
        return _rs_state(rs, out), _fired(faults)
    got, want = _both(model, scenario)
    assert got == want


def test_death_migration_restart_like_reference(model):
    def scenario(side):
        S, F = side[2], side[3]
        faults = F.FaultInjector([F.FaultSpec("replica_raise", at_step=s, replica=0)
                                  for s in (4, 5)])
        rs, clock = _replica_set(side, faults=faults)
        out = _drain(rs, clock, _reqs(S, 8, gen=6))
        assert rs.stats["deaths"] == rs.stats["restarts"] == 1
        assert [t[2] for t in rs.health[0].transitions] == \
            ["suspect", "dead", "recovering", "healthy"]
        if S is P:                           # migration is output-invisible
            clean_rs, clean_clock = _replica_set(side)
            assert _out(out) == _out(_drain(clean_rs, clean_clock, _reqs(S, 8, gen=6)))
        for e in rs.engines:
            e.allocator.check_leaks(0)
        return _rs_state(rs, out), _fired(faults)
    got, want = _both(model, scenario)
    assert got == want


def _failing_factory(side, clock, faults, *, survivor: bool):
    """Replica 0's rebuilds all raise (with ``survivor``, replica 1 serves
    on); without one every build after the first raises."""
    built = [0, 0]

    def factory(i):
        built[i] += 1
        if (i == 0 or not survivor) and sum(built) > (2 if survivor else 1):
            raise RuntimeError("device gone for good")
        return _engine(side, clock=clock, fault_injector=faults, replica_id=i)

    return factory


def test_restart_failure_exhausts_to_failed_like_reference(model):
    def scenario(side):
        S, F = side[2], side[3]
        L = JL if S is J else PL
        clock = S.VirtualClock()
        faults = F.FaultInjector([F.FaultSpec("replica_raise", at_step=s, replica=0)
                                  for s in (3, 4)], clock=clock)
        kw = {} if S is J else {"devices": ["cpu", "cpu"]}
        rs = L.ReplicaSet(_failing_factory(side, clock, faults, survivor=True), 2,
                          clock=clock, fault_injector=faults,
                          health=L.HealthConfig(**HEALTH), **kw)
        out = _drain(rs, clock, _reqs(S, 8, gen=6))
        _settle(rs, clock)
        assert rs.health[0].state == "failed" and rs.health[0].restarts == 2
        assert "device gone" in rs.health[0].last_error
        assert rs.health[1].state == "healthy"
        return _rs_state(rs, out), _fired(faults)
    got, want = _both(model, scenario)
    assert got == want


def test_all_replicas_failed_raises_like_reference(model):
    def scenario(side):
        S, F = side[2], side[3]
        L = JL if S is J else PL
        clock = S.VirtualClock()
        faults = F.FaultInjector([F.FaultSpec("replica_raise", at_step=s, replica=0)
                                  for s in (2, 3)], clock=clock)
        rs = L.ReplicaSet(_failing_factory(side, clock, faults, survivor=False), 1,
                          clock=clock, fault_injector=faults,
                          health=L.HealthConfig(**{**HEALTH, "backoff_cap_s": 0.2,
                                                   "max_restarts": 1}))
        with pytest.raises(RuntimeError, match="failed permanently") as e:
            rs.run(_reqs(S, 4))
        return str(e.value), [(h.state, h.restarts, h.transitions) for h in rs.health]
    got, want = _both(model, scenario)
    assert got == want


def test_submit_fail_fast_and_dead_replica_gets_nothing_like_reference(model):
    def scenario(side):
        S, F = side[2], side[3]
        L = JL if S is J else PL
        faults = F.FaultInjector([F.FaultSpec("replica_raise", at_step=s, replica=0)
                                  for s in (2, 3)])
        rs, clock = _replica_set(side, faults=faults, health=L.HealthConfig(
            step_deadline_s=1.0, dead_after=2, restart_backoff_s=1e6,
            backoff_cap_s=1e6, max_restarts=1))
        errs = []
        for bad in (np.arange(100), np.zeros(0, np.int32)):
            with pytest.raises(ValueError, match="no replica can ever admit") as e:
                rs.submit(S.Request(rid=90, prompt=bad, max_new_tokens=4))
            errs.append(str(e.value))
        for r in _reqs(S, 8):
            rs.submit(r)
        out, before = {}, None
        for _ in range(500):
            if not rs._queue and not any(e.busy for e in rs.engines):
                break
            if rs.health[0].state == "dead" and before is None:
                before = rs.dispatched[0]
            out.update(rs.step())
            clock.advance(0.01)
        assert len(out) == 8 and rs.health[0].state == "dead"
        assert rs.dispatched[0] == before
        return errs, _rs_state(rs, out)
    got, want = _both(model, scenario)
    assert got == want


def test_ship_truncate_fails_restart_like_reference(model, tmp_path):
    from repro.ckpt import ShipArtifactError as JErr
    from repro.ckpt import load_ship_weights as jload
    from repro.ckpt import save_ship_weights as jsave
    from repro.precision.qat import quantize_param_tree
    from repro_torch.ckpt import ShipArtifactError as PErr
    from repro_torch.ckpt import load_ship_weights as pload
    from repro_torch.ckpt import save_ship_weights as psave

    bp = jax.jit(lambda p: quantize_param_tree(p, bits=8, layout="bitplane"))(model["j"][1])

    def scenario(side):
        S, F = side[2], side[3]
        L, save, load, err = (JL, jsave, jload, JErr) if S is J else \
            (PL, psave, lambda d: pload(d, device="cpu"), PErr)
        ship = str(tmp_path / f"ship-{'j' if S is J else 't'}")
        save(ship, bp if S is J else bridge(bp))
        clock = S.VirtualClock()
        faults = F.FaultInjector(
            [F.FaultSpec("replica_raise", at_step=s, replica=0) for s in (3, 4)]
            + [F.FaultSpec("ship_truncate", at_step=0, replica=0)], clock=clock)

        def factory(i):
            load(ship)
            return _engine(side, clock=clock, fault_injector=faults, replica_id=i)

        rs = L.ReplicaSet(factory, 2, clock=clock, fault_injector=faults,
                          health=L.HealthConfig(**{**HEALTH, "backoff_cap_s": 0.2,
                                                   "max_restarts": 1}),
                          ship_dir=ship)
        out = _drain(rs, clock, _reqs(S, 8, gen=6))
        _settle(rs, clock)
        assert rs.health[0].state == "failed"
        assert "ShipArtifactError" in rs.health[0].last_error
        with pytest.raises(err):
            load(ship)
        return _out(out), dict(rs.stats), [(h.state, h.restarts) for h in rs.health]
    got, want = _both(model, scenario)
    assert got == want


def test_port_replica_step_propagates_other_errors(model):
    """Only an injected device loss is absorbed: any other error out of a
    replica's step (a kernel's launch error, say) reaches the caller."""
    rs, clock = _replica_set(model["t"])

    def boom():
        raise RuntimeError("kernel launch failed")

    rs.engines[0].step = boom
    rs.submit(P.Request(rid=0, prompt=np.arange(6), max_new_tokens=2))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        rs.step()
