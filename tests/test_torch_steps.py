"""The dry run's step functions (``repro_torch.launch.steps``) against the
JAX package's (``repro/launch/steps.py``), reduced gemma-2b in f32 on the
same numpy-made tokens and the reference's parameters:

  * ``make_train_step(microbatches=M)``: gradients added in f32 in
    micro-batch order, the loss the mean over the micro-batches; one SGD
    step (its update is linear in the gradients, so the parameters show
    the gradients' agreement) at M = 1, 2 and 4 against the reference's
    jitted step: the loss within rtol 1e-5, every leaf's update within
    1e-5 of its largest plus 2 ulp of the leaf (the f32 rounding of the
    new parameter);
  * ``make_prefill_step`` / ``make_decode_step``: the last-token logits
    within the same bounds.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import Model as JModel
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import Model
from repro_torch.models.layers import TensorSpec
from repro_torch.optim import make_optimizer

CFG = reduced(get_config("gemma-2b"))
LR = 0.1


@pytest.fixture(autouse=True)
def _no_stale_group():
    """Other test files leave their world-1 gloo group behind in the
    worker process that runs this file next; the dry run and the fake
    worlds here make their own default group, so a stale one goes first."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JModel(jreduced(
        jget_config("gemma-2b"))).init(jax.random.PRNGKey(0)))


@pytest.fixture
def world1():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def _close(got, want):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("M", [1, 2, 4])
def test_microbatched_train_step_matches_the_reference(jax_params, world1,
                                                       M):
    tokens = _tokens((4, 32))
    jmodel = JModel(jreduced(jget_config("gemma-2b")))
    jopt = jmake_optimizer("sgd", lr=LR)
    jp, _, jloss = jax.jit(jmake_train_step(jmodel, jopt, microbatches=M))(
        jax_params, jopt.init(jax_params), {"tokens": jnp.asarray(tokens)},
        jnp.int32(0))
    params = params_from_jax(jax_params, CFG, device="cpu")
    opt = make_optimizer("sgd", lr=LR)
    loss = make_train_step(Model(CFG), opt, microbatches=M)(
        params, opt.init(params), {"tokens": torch.from_numpy(tokens)}, 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for a, b, p0 in zip(tree_leaves(params), jax.tree.leaves(jp),
                        jax.tree.leaves(jax_params)):
        # the step moved each leaf by -lr·grad: the updates agree within
        # 1e-5 of their largest, plus the rounding of p0 + update to f32
        # (2 ulp of the leaf's largest magnitude)
        b = np.asarray(b)
        bound = (1e-5 * np.abs(b - p0).max()
                 + 2 * np.spacing(np.abs(b).max()))
        assert np.abs(a.detach().numpy() - b).max() <= bound


def test_microbatches_must_split_the_batch(world1):
    params = Model(CFG).init(torch.Generator().manual_seed(0))
    opt = make_optimizer("sgd", lr=LR)
    step = make_train_step(Model(CFG), opt, microbatches=3)
    with pytest.raises(ValueError, match="do not split into 3"):
        step(params, opt.init(params),
             {"tokens": torch.from_numpy(_tokens((4, 8)))}, 0)


def test_prefill_and_decode_steps_match_the_reference(jax_params):
    jmodel = JModel(jreduced(jget_config("gemma-2b")))
    tokens = _tokens((2, 16), seed=1)
    jlogits, jcache = jax.jit(jmake_prefill_step(jmodel))(
        jax_params, {"tokens": jnp.asarray(tokens)})
    params = params_from_jax(jax_params, CFG, device="cpu")
    model = Model(CFG)
    logits, cache = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(tokens)})
    _close(logits.numpy(), jlogits)
    # one decode step against a zero 16-entry cache at position 5
    nxt = tokens[:, :1]
    jcache0 = jmodel.init_cache(2, 16)
    jzero = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jcache0)
    jl, _ = jax.jit(jmake_decode_step(jmodel))(
        jax_params, jnp.asarray(nxt), jzero, jnp.int32(5))
    zero = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                    model.init_cache(2, 16),
                    is_leaf=lambda x: isinstance(x, TensorSpec))
    tl, _ = make_decode_step(model)(params, torch.from_numpy(nxt), zero, 5)
    _close(tl.numpy(), jl)
