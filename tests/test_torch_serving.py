"""The port's serving subsystem (``repro_torch.serve``), ported from
``tests/test_serving.py`` and held against the JAX engine.

  * page allocator invariants and the simulated scheduler (no device);
  * BIT-IDENTITY at temperature 0: the continuous engine — paged pool,
    vector-position decode, active-slot masking, mid-stream admissions —
    emits exactly the tokens of the port's static ``generate``.  PyTorch's
    CPU matrix products give the same rows for every batch of two or more
    rows but take another path for one row, so ``generate`` runs here at a
    batch of at least two (the reference compares against batch 1);
  * the int8 engine against the JAX int8 engine on the same weights and
    prompts: greedy tokens equal, int8 payloads equal except ±1 on at most
    1% of entries, scales within rel 1e-5.  Both quantize bit-equally
    (``test_torch_kernels.py``); what differs is their input: the cached
    K/V of the second layer differ between the frameworks by f32 matmul
    rounding (measured up to 1.1e-6 relative on the scales, so the 1e-6
    first planned was too tight), which can move a value across a
    rounding boundary.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_parser, generate
from repro_torch.models import Model
from repro_torch.serve import (Engine, LeastLoadedRouter, MultiReplicaServer,
                               PageAllocator, Request, ServeConfig, SimCosts,
                               TRASH_PAGE, latency_summary, run_static)


@pytest.fixture(scope="module")
def gemma():
    jcfg = jreduced(jget_config("gemma-2b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("gemma-2b"))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, Model(cfg), params, jmodel, jparams


def _prompts(cfg, n, P, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, P)).astype(np.int32)


def test_reduced_flag_parsing_and_no_plan():
    # --plan (the planner's serving placement search) is ported now: it
    # is off by default, and takes the reference's topology and budget
    ap = build_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args(["--device", "cpu"]).device == "cpu"
    assert ap.parse_args([]).plan is False
    args = ap.parse_args(["--plan"])
    assert (args.plan, args.topology, args.latency_budget_ms) == \
        (True, "two_tier_pod", 0.0)


# ---------------------------------------------------------------------------
# page allocator + simulated scheduler
# ---------------------------------------------------------------------------

def test_page_allocator_invariants():
    a = PageAllocator(n_pages=9, page_size=4, length=16, max_batch=3)
    assert a.pages_needed(1) == 1 and a.pages_needed(5) == 2
    assert a.pages_needed(999) == 4          # capped at pages_per_slot
    a.alloc(0, 8)
    a.alloc(1, 5)
    a.check()
    assert TRASH_PAGE not in a.live_pages()
    with pytest.raises(RuntimeError):
        a.alloc(0, 4)                        # double alloc
    assert a.free(1) == 2
    assert (a.table()[1] == TRASH_PAGE).all()
    a.alloc(2, 16)
    a.check()
    with pytest.raises(RuntimeError):
        a.alloc(1, 16)                       # 2 free pages < 4 needed
    a.check()


def test_no_page_leaks_or_aliasing(gemma):
    cfg, model, *_ = gemma
    eng = Engine(model, None, ServeConfig(max_batch=3, max_len=16,
                                          page_size=4), sim=SimCosts())
    for i in range(5):
        eng.submit(Request(rid=i, prompt=_prompts(cfg, 1, 8)[0],
                           max_new=[8, 3, 5, 8, 2][i], arrival_s=0.002 * i))
    seen = []
    while eng.busy():
        eng.step()
        eng.cache.check()
        seen.append(sum(len(a.live_pages())
                        for a in eng.cache.allocators.values()))
    assert max(seen) > 0
    for alloc in eng.cache.allocators.values():   # drained: no leaks
        assert not alloc.live_pages()


def test_oversubscribed_pool_defers_admission(gemma):
    cfg, model, *_ = gemma
    eng = Engine(model, None, ServeConfig(max_batch=4, max_len=16,
                                          page_size=4, n_pages=9),
                 sim=SimCosts())
    out = eng.run([Request(rid=i, prompt=_prompts(cfg, 1, 8)[0], max_new=8)
                   for i in range(6)])
    assert sorted(c.rid for c in out) == list(range(6))
    assert all(len(c.tokens) == 8 for c in out)


def test_zero_token_completion(gemma):
    cfg, model, *_ = gemma
    reqs = [Request(rid=0, prompt=_prompts(cfg, 1, 8)[0], max_new=0),
            Request(rid=1, prompt=_prompts(cfg, 1, 8)[0], max_new=4)]
    out = {c.rid: c for c in Engine(
        model, None, ServeConfig(max_batch=2, max_len=16, page_size=4),
        sim=SimCosts()).run(reqs)}
    assert len(out[0].tokens) == 0 and out[0].finish_s == out[0].admit_s
    assert len(out[1].tokens) == 4
    summ = latency_summary(list(out.values()))
    assert summ["tokens"] == 4 and all(np.isfinite(v) for v in summ.values())
    stat = {c.rid: c for c in run_static(model, None, reqs, max_batch=2,
                                         max_len=16, sim=SimCosts())}
    assert len(stat[0].tokens) == 0 and len(stat[1].tokens) == 4


def test_least_loaded_router_ties_round_robin():
    r = LeastLoadedRouter()
    assert r.pick([0, 0, 0]) == 0
    assert r.pick([1, 0, 0]) == 2
    assert r.pick([1, 0, 1]) == 1
    assert r.pick([1, 1, 1]) == 0


def test_multi_replica_server_drains(gemma):
    cfg, model, *_ = gemma
    srv = MultiReplicaServer(
        [Engine(model, None, ServeConfig(max_batch=2, max_len=16,
                                         page_size=4), sim=SimCosts())
         for _ in range(2)])
    out = srv.run([Request(rid=i, prompt=_prompts(cfg, 1, 8)[0], max_new=4)
                   for i in range(6)])
    assert sorted(c.rid for c in out) == list(range(6))
    assert sorted(set(srv.routes)) == [0, 1]


def test_sim_continuous_beats_static(gemma):
    cfg, model, *_ = gemma
    sim = SimCosts()
    reqs = [Request(rid=i, prompt=_prompts(cfg, 1, 8)[0],
                    max_new=24 if i % 4 == 0 else 4) for i in range(12)]
    cont = latency_summary(Engine(model, None, ServeConfig(
        max_batch=4, max_len=32, page_size=8), sim=sim).run(reqs))
    stat = latency_summary(run_static(model, None, reqs, 4, 32, sim=sim))
    assert cont["tokens"] == stat["tokens"]
    assert cont["makespan_s"] < stat["makespan_s"]
    assert cont["p99_s"] <= stat["p99_s"]


# ---------------------------------------------------------------------------
# bit-identity at temperature 0: engine vs the port's generate
# ---------------------------------------------------------------------------

def test_engine_bit_identical(gemma):
    cfg, model, params, *_ = gemma
    P, G, ML = 8, 8, 16
    prompts = _prompts(cfg, 3, P)
    ref = generate(model, params, prompts, gen=G, max_len=ML).numpy()
    eng = Engine(model, params, ServeConfig(max_batch=3, max_len=ML,
                                            page_size=4))
    out = eng.run([Request(rid=i, prompt=prompts[i], max_new=G)
                   for i in range(3)])
    for c in out:
        np.testing.assert_array_equal(c.tokens, ref[c.rid])
    # one admission per tick: the third request joins at tick 3
    assert eng.prefills == 3 and eng.decode_ticks == 2 + (G - 1)


def test_engine_bit_identical_midstream_admission(gemma):
    # 5 requests through 2 slots: retirements free slots mid-stream and
    # later admissions join a half-full batch; each row must equal the
    # greedy prefix of the batched reference
    cfg, model, params, *_ = gemma
    P, ML = 8, 16
    gens = [8, 3, 5, 8, 2]
    prompts = _prompts(cfg, 5, P)
    ref = generate(model, params, prompts, gen=max(gens), max_len=ML).numpy()
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=ML,
                                            page_size=4))
    out = eng.run([Request(rid=i, prompt=prompts[i], max_new=gens[i])
                   for i in range(5)])
    assert len(out) == 5
    for c in out:
        np.testing.assert_array_equal(c.tokens, ref[c.rid, :gens[c.rid]])
    assert not any(a.live_pages() for a in eng.cache.allocators.values())


def test_run_static_matches_generate(gemma):
    cfg, model, params, *_ = gemma
    P, G, ML = 8, 4, 12
    prompts = _prompts(cfg, 2, P)
    ref = generate(model, params, prompts, gen=G, max_len=ML).numpy()
    out = run_static(model, params,
                     [Request(rid=i, prompt=prompts[i], max_new=G)
                      for i in range(2)], max_batch=2, max_len=ML)
    for c in out:
        np.testing.assert_array_equal(c.tokens, ref[c.rid])


def test_sampling_is_seeded_per_request(gemma):
    cfg, model, params, *_ = gemma
    prompts = _prompts(cfg, 2, 8)

    def run(seed):
        eng = Engine(model, params, ServeConfig(max_batch=2, max_len=16,
                                                page_size=4, seed=seed))
        return [c.tokens for c in eng.run(
            [Request(rid=i, prompt=prompts[i], max_new=6, temperature=1.0)
             for i in range(2)])]

    a, b = run(0), run(0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert ((x >= 0) & (x < cfg.vocab_size)).all()


# ---------------------------------------------------------------------------
# int8 paged KV: the port against the JAX engine
# ---------------------------------------------------------------------------

def test_int8_engine_matches_jax_int8_engine(gemma):
    cfg, model, params, jmodel, jparams = gemma
    P, ML = 8, 16
    gens = [6, 3, 5]
    prompts = _prompts(cfg, 3, P, seed=4)
    scfg = dict(max_batch=2, max_len=ML, page_size=4, quantize="int8")
    jeng = JEngine(jmodel, jparams, JServeConfig(**scfg))
    jout = jeng.run([JRequest(rid=i, prompt=prompts[i], max_new=gens[i])
                     for i in range(3)])
    ops.reset_launch_counts()
    eng = Engine(model, params, ServeConfig(**scfg))
    out = eng.run([Request(rid=i, prompt=prompts[i], max_new=gens[i])
                   for i in range(3)])
    # CPU tensors take the plain versions: every kernel counter stays at 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
    for c, jc in zip(out, jout):
        np.testing.assert_array_equal(c.tokens, jc.tokens)

    # same admissions and ticks, so the same pages hold the same entries;
    # page 0 (trash) takes colliding inactive-row writes and is skipped
    differ = total = 0
    for leaf in ("k", "v"):
        q = eng.pool[0][0][leaf]["q"][:, 1:].numpy().astype(np.int32)
        s = eng.pool[0][0][leaf]["s"][:, 1:].numpy()
        jq = np.asarray(jeng.pool[0][0][leaf]["q"])[:, 1:].astype(np.int32)
        js = np.asarray(jeng.pool[0][0][leaf]["s"])[:, 1:]
        np.testing.assert_allclose(s, js, rtol=1e-5, atol=0)
        assert np.abs(q - jq).max() <= 1
        differ += int((q != jq).sum())
        total += q.size
    assert differ <= 0.01 * total, f"{differ}/{total} int8 entries differ"


def test_int8_pool_layout_and_launch_count_formula(gemma, monkeypatch):
    # gemma-2b is one segment of stacked repeats: the int8 pool is one
    # (R, n_pages, page, KV, hd) tensor per leaf, so a prefill write and a
    # decode tick each quantize once per leaf (k and v) for all layers
    cfg, model, params, *_ = gemma
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=16,
                                            page_size=4, quantize="int8"))
    q = eng.pool[0][0]["k"]["q"]
    assert q.dtype == torch.int8
    assert tuple(q.shape) == (cfg.num_layers, 1 + 2 * 4, 4,
                              cfg.num_kv_heads, cfg.hd)
    assert eng.cache.paged_leaves() == 2
    calls = []
    real = ops.quantize_tiles

    def spy(x, *, tile):
        calls.append((x.numel(), tile))
        return real(x, tile=tile)

    monkeypatch.setattr(ops, "quantize_tiles", spy)
    eng.run([Request(rid=i, prompt=_prompts(cfg, 2, 8)[i], max_new=4)
             for i in range(2)])
    assert len(calls) == eng.cache.paged_leaves() * (eng.prefills
                                                     + eng.decode_ticks)
    assert all(tile == cfg.hd for _, tile in calls)


def test_int8_engine_matches_jax_for_windowed_gemma2():
    # reduced gemma2-9b (G = 2): its local layers keep a ring of the
    # window (32) and its global layers the whole max_len (48), so the
    # paged pool has two length groups; prompts are longer than the
    # window, so the prefill writes a wrapped ring
    over = dict(num_kv_heads=2)
    jcfg = dataclasses.replace(jreduced(jget_config("gemma2-9b")), **over)
    cfg = dataclasses.replace(reduced(get_config("gemma2-9b")), **over)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    P, ML, gens = 36, 48, [6, 3, 5]
    prompts = _prompts(cfg, 3, P, seed=7)
    scfg = dict(max_batch=2, max_len=ML, page_size=8, quantize="int8")
    jout = JEngine(jmodel, jparams, JServeConfig(**scfg)).run(
        [JRequest(rid=i, prompt=prompts[i], max_new=gens[i])
         for i in range(3)])
    ops.reset_launch_counts()
    eng = Engine(Model(cfg), params, ServeConfig(**scfg))
    out = eng.run([Request(rid=i, prompt=prompts[i], max_new=gens[i])
                   for i in range(3)])
    assert sorted(eng.cache.allocators) == [cfg.window_size, ML]
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
    assert [len(c.tokens) for c in out] == gens
    for c, jc in zip(out, jout):
        np.testing.assert_array_equal(c.tokens, jc.tokens)
    assert not any(a.live_pages() for a in eng.cache.allocators.values())


# ---------------------------------------------------------------------------
# The MoE and MLA families: the port's engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8"], ids=["plain", "int8"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-30b-a3b"])
def test_moe_and_mla_engines_match_jax(arch, quantize, monkeypatch):
    """3 requests through 2 slots, max_len 16, page 4: the greedy tokens
    equal the reference engine's.  MLA pages its two latents per segment
    (``c_kv`` tile 512 at full width, 64 here; ``k_rope`` 64 / 16), and
    the int8 pool quantizes every paged leaf through
    ``ops.quantize_tiles`` with its trailing dim as the tile, once per
    admission and decode tick."""
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    P, gens = 8, [6, 3, 5]
    prompts = _prompts(cfg, 3, P, seed=9)
    scfg = dict(max_batch=2, max_len=16, page_size=4, quantize=quantize)
    jout = JEngine(jmodel, jparams, JServeConfig(**scfg)).run(
        [JRequest(rid=i, prompt=prompts[i], max_new=gens[i])
         for i in range(3)])
    calls = []
    real = ops.quantize_tiles

    def spy(x, *, tile):
        calls.append(tile)
        return real(x, tile=tile)

    monkeypatch.setattr(ops, "quantize_tiles", spy)
    ops.reset_launch_counts()
    eng = Engine(Model(cfg), params, ServeConfig(**scfg))
    out = eng.run([Request(rid=i, prompt=prompts[i], max_new=gens[i])
                   for i in range(3)])
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
    assert [len(c.tokens) for c in out] == gens
    for c, jc in zip(out, jout):
        np.testing.assert_array_equal(c.tokens, jc.tokens)
    assert not any(a.live_pages() for a in eng.cache.allocators.values())
    mla = arch == "deepseek-v2-lite-16b"
    leaves = eng.cache.paged_leaves()
    assert leaves == (4 if mla else 2)
    if quantize:
        assert len(calls) == leaves * (eng.prefills + eng.decode_ticks)
        want = ({cfg.kv_lora_rank, cfg.qk_rope_dim} if mla else {cfg.hd})
        assert set(calls) == want
        if mla:
            pool = eng.pool[0][0]
            assert sorted(pool) == ["c_kv", "k_rope"]
            assert pool["c_kv"]["q"].dtype == torch.int8
            assert pool["c_kv"]["q"].shape[-1] == cfg.kv_lora_rank
    else:
        assert not calls
