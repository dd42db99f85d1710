"""The port's fault-tolerant training loop (``ft.RestartManager``) and its
training checkpoints, held to the JAX package on the CPU.

The restart scenarios are tests/test_substrates.py's (a failure injected
at step 9 with a checkpoint every 4 steps, then a second ``run``) and a
train step wrapped to report a NaN loss once, at step 6: both packages
take the same counts (``resumed_from``, the final step, the losses kept,
the rollbacks, ``repro_ft_rollbacks_total``).  On the CPU the port's
resumed run equals an uninterrupted one bit for bit.  Training
checkpoints cross-restore: a ``TrainState`` written by either package
restores in the other (manifests equal, leaf for leaf) and trains on as
the writer does, within the tolerances of tests/test_torch_train.py
(loss rtol 1e-5; Adafactor's params within 1e-5 of max|p|, and with int8
compression as ``_params_close`` says, each compressed step from a state
both packages share).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro import train as JT
from repro.data import TokenPipeline as JPipe
from repro.ft import RestartManager as JRestartManager
from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import checkpoint as C
from repro_torch import configs, convert, obs
from repro_torch import train as T
from repro_torch.data import TokenPipeline
from repro_torch.ft import RestartManager
from repro_torch.ft.restart import TrainLoopResult
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.faults

SUB = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
           d_ff=64, vocab_size=64, param_dtype="float32",
           compute_dtype="float32", remat=True)
NAN_AT = 6


@pytest.fixture(scope="module")
def jax_side():
    """tests/test_substrates.py's setup in the JAX package."""
    cfg = JModelConfig(**SUB)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    opt = JT.adamw(JT.warmup_cosine(3e-3, 5, 100))
    state = JT.init_train_state(params, opt)
    step = jax.jit(JT.build_train_step(cfg, opt, grad_accum=2))
    return state, step, JPipe(cfg.vocab_size, batch=8, seq_len=16, seed=0)


def port_side(donate=False):
    cfg = ModelConfig(**SUB)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = T.adamw(T.warmup_cosine(3e-3, 5, 100))
    state = T.init_train_state(params, opt)
    step = T.build_train_step(cfg, opt, grad_accum=2, donate=donate)
    return state, step, TokenPipeline(cfg.vocab_size, batch=8, seq_len=16, seed=0)


def nan_once(step_fn, pipe, at: int, wait=None):
    """``step_fn`` reporting a NaN loss the first time it is given batch
    ``at`` (after ``wait()``, so a save in flight has landed)."""
    bad = pipe.batch_at(at)["tokens"]
    seen = []

    def step(state, batch):
        new, m = step_fn(state, batch)
        if not seen and np.array_equal(np.asarray(batch["tokens"]), bad):
            seen.append(1)
            if wait is not None:
                wait()
            m = dict(m, loss=m["loss"] * float("nan"))
        return new, m

    step.donate = getattr(step_fn, "donate", False)
    return step


def counts(res) -> tuple:
    return (res.resumed_from, int(np.asarray(res.state.step)), len(res.losses),
            res.nan_rollbacks)


def test_restart_resumes_like_jax(jax_side, tmp_path):
    jstate, jstep, jpipe = jax_side
    jrm = JRestartManager(str(tmp_path / "jax"), save_every=4)
    with pytest.raises(RuntimeError):
        jrm.run(jstate, jstep, jpipe, total_steps=12, inject_failure_at=9)
    jres = jrm.run(jstate, jstep, jpipe, total_steps=12)

    state, step, pipe = port_side()
    rm = RestartManager(str(tmp_path / "port"), save_every=4)
    with pytest.raises(RuntimeError, match="injected failure at step 9"):
        rm.run(state, step, pipe, total_steps=12, inject_failure_at=9)
    res = rm.run(state, step, pipe, total_steps=12)
    assert isinstance(res, TrainLoopResult)
    assert counts(res) == counts(jres) == (8, 12, 4, 0)
    assert np.isfinite(res.losses).all() and len(res.step_times) == 4

    # the resumed run ends where an uninterrupted one does, bit for bit
    clean = RestartManager(str(tmp_path / "clean"), save_every=4).run(
        state, step, pipe, total_steps=12)
    for a, b in zip(res.state.params.parameters(), clean.state.params.parameters()):
        assert torch.equal(a, b)
    assert res.losses == clean.losses[8:]
    # state, the template restores were made from, is untouched
    assert int(state.step) == 0


@pytest.mark.parametrize("donate", [False, True])
def test_nan_rollback_like_jax(jax_side, tmp_path, donate):
    jstate, jstep, jpipe = jax_side
    jrm = JRestartManager(str(tmp_path / "jax"), save_every=4)
    jres = jrm.run(jstate, nan_once(jstep, jpipe, NAN_AT, jrm.mgr.wait), jpipe,
                   total_steps=12)

    rollbacks = obs.REGISTRY.get("repro_ft_rollbacks_total")
    r0 = rollbacks.value()
    state, step, pipe = port_side(donate)
    rm = RestartManager(str(tmp_path / "port"), save_every=4)
    res = rm.run(state, nan_once(step, pipe, NAN_AT), pipe, total_steps=12)
    # restored to step 4, batch 4 skipped, then on to the end
    assert counts(res) == counts(jres) == (None, 11, 13, 1)
    assert rollbacks.value() == r0 + 1
    assert np.isfinite(res.losses).all()


def test_nan_rollback_with_donation_and_no_checkpoint_raises(tmp_path):
    state, step, pipe = port_side(donate=True)
    rm = RestartManager(str(tmp_path), save_every=100)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        rm.run(state, nan_once(step, pipe, 2), pipe, total_steps=5)
    # without donation the loop keeps the state it had and goes on
    state, step, pipe = port_side()
    res = RestartManager(str(tmp_path / "kept"), save_every=100).run(
        state, nan_once(step, pipe, 2), pipe, total_steps=5)
    assert res.nan_rollbacks == 1 and int(res.state.step) == 4


# -- training checkpoints across the packages ------------------------------------


def _cfg(name="granite-3-8b"):
    return configs.get_smoke(name).replace(param_dtype="float32",
                                           compute_dtype="float32")


def _jax_state(cfg, compress):
    opt = JT.adafactor(JT.warmup_cosine(1e-2, 1, 10))
    params = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    state = JT.init_train_state(params, opt, compress=compress)
    step = jax.jit(JT.build_train_step(cfg, opt, compress_grads=compress))
    return state, step


def _port_step(cfg, compress):
    opt = T.adafactor(T.warmup_cosine(1e-2, 1, 10))
    return T.build_train_step(cfg, opt, compress_grads=compress)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _pairs(port_state, jax_state):
    """(path, port array, JAX array) over every leaf of the JAX state."""
    got = convert.train_state_to_numpy(port_state)
    got = jax_state._replace(params=got["params"], opt_state=got["opt_state"],
                             step=got["step"], ef=got["ef"])
    for (path, want), mine in zip(jax.tree_util.tree_leaves_with_path(jax_state),
                                  jax.tree.leaves(got)):
        yield path, np.asarray(mine), np.asarray(want)


def _params_close(port_state, jax_state, compress):
    """Params after training on: within 1e-5 of max|p|.  With int8
    compression an element near a rounding boundary may take the
    neighbouring code in the other package and its param moves by up to
    lr (1e-2) a step: there 99% of the elements are held within 1e-5 and
    every one within 2 lr."""
    for path, a, w in _pairs(port_state, jax_state):
        if path[0].name != "params":
            continue
        d = np.abs(a - w)
        tol = 1e-5 * max(np.abs(w).max(), 1e-30)
        if compress:
            assert (d <= tol).mean() >= 0.99 and d.max() <= 2e-2, path
        else:
            assert d.max() <= tol, path


def _train_on(cfg, compress, jstate, jstep, state, step, pipe):
    """Steps 2 and 3 in both packages after a cross-package restore, the
    loss of each within rtol 1e-5.  Uncompressed, both run free from the
    restored states and the params are held after the second step.  With
    int8 compression each step starts from one state in both packages --
    the restored one (equal bit for bit), then JAX's after step 2, carried
    into the port -- and the params are held after each: free-running
    compressed runs part where the two frameworks' f32 sums put one element
    on either side of an int8 rounding boundary, and error feedback carries
    that code into every later step
    (test_one_int8_code_apart_upstream_parts_the_embedding), which tests
    the compressor's chaos, not the restore."""
    jb = lambda i: {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
    for i in range(2, 4):
        if compress and i > 2:
            state = convert.train_state_from_numpy(
                cfg, jax.tree.map(np.asarray, jstate), "cpu")
        jstate, jm = jstep(jstate, jb(i))
        state, m = step(state, pipe.batch_at(i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        if compress or i == 3:
            _params_close(state, jstate, compress)


@pytest.mark.parametrize("name,compress", [("deepseek-v3-671b", False),
                                           ("granite-3-8b", True)],
                         ids=["plain", "ef"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, name, compress):
    """JAX trains 2 steps and saves; the port restores exactly those arrays
    into its own state's structure and trains 2 more, as JAX does (with
    int8 compression each step from a state both packages share:
    free-running compressed runs part by one int8 code, as
    test_one_int8_code_apart_upstream_parts_the_embedding shows)."""
    cfg = _cfg(name)
    jstate, jstep = _jax_state(cfg, compress)
    pipe = TokenPipeline(cfg.vocab_size, 2, 16, seed=1)
    jb = lambda i: {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
    for i in range(2):
        jstate, _ = jstep(jstate, jb(i))
    JC.save(jstate, str(tmp_path), 2)

    template = convert.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, _jax_state(cfg, compress)[0]), "cpu")
    state, used = C.restore(template, str(tmp_path))
    assert used == 2 and int(state.step) == 2
    assert state.params is not template.params
    assert (state.ef is None) == (not compress)
    for path, a, w in _pairs(state, jstate):
        assert np.array_equal(a, w), path
    # the port writes the same manifest for the state it restored
    C.save(state, str(tmp_path / "port"), 2)
    assert _manifest(tmp_path / "port", 2)["leaves"] == _manifest(tmp_path, 2)["leaves"]

    _train_on(cfg, compress, jstate, jstep, state, _port_step(cfg, compress), pipe)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port trains 2 int8-compressed steps and saves; JAX restores
    exactly those arrays and trains 2 more as the port does, each step from
    a state both packages share (free-running compressed runs part by one
    int8 code, as test_one_int8_code_apart_upstream_parts_the_embedding
    shows)."""
    cfg = _cfg()
    jstate0, jstep = _jax_state(cfg, True)
    state = convert.train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate0),
                                           "cpu")
    step = _port_step(cfg, True)
    pipe = TokenPipeline(cfg.vocab_size, 2, 16, seed=1)
    for i in range(2):
        state, _ = step(state, pipe.batch_at(i))
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save_async(state, 2)
    mgr.wait()
    jstate, used = JC.restore(jstate0, str(tmp_path))
    assert used == 2 and int(jstate.step) == 2
    for path, a, w in _pairs(state, jstate):
        assert np.array_equal(a, w), path
    _train_on(cfg, True, jax.tree.map(jnp.asarray, jstate), jstep, state, step,
              pipe)


def test_bf16_train_state_checkpoint(tmp_path):
    """bfloat16 params: the port writes them as the JAX package does (raw
    two bytes, manifest dtype bfloat16; the manifests are equal) and
    restores both packages' files bit for bit."""
    cfg = configs.get_smoke("granite-3-8b")
    assert cfg.param_dtype == "bfloat16"
    opt = JT.adamw(JT.warmup_cosine(1e-3, 1, 10))
    jstate = JT.init_train_state(JM.init_params(jax.random.PRNGKey(0), cfg), opt)
    JC.save(jstate, str(tmp_path / "jax"), 1)
    state = convert.train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate),
                                           "cpu")
    assert state.params.embed.table.dtype == torch.bfloat16
    C.save(state, str(tmp_path / "port"), 1)
    assert _manifest(tmp_path / "port", 1)["leaves"] == _manifest(tmp_path / "jax", 1)["leaves"]
    for src in ("jax", "port"):
        got, _ = C.restore(state, str(tmp_path / src))
        for a, b in zip(got.params.parameters(), state.params.parameters()):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert int(got.step) == 0


# -- where the int8-compressed runs part -------------------------------------------


def test_int8_compressor_matches_jax_on_identical_grads():
    """The compressor is the JAX package's bit for bit: from the same
    gradients and error feedback (a stacked leaf and a plain one, with
    elements placed exactly on rounding boundaries) the dequantized
    gradients and the new residuals are equal, the scale ``max|g + e| /
    127`` taken over the whole stacked leaf."""
    from repro.train import step as JS
    from repro_torch.train import step as PS
    from repro_torch.train.optim import LayerStack

    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((3, 8, 16)).astype(np.float32),
         "b": rng.standard_normal((40,)).astype(np.float32)}
    e = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in g.items()}
    scale = np.float32(np.abs(g["b"] + e["b"]).max()) / np.float32(127.0)
    e["b"][:4] = 0.0
    g["b"][:4] = np.float32([0.5, 1.5, -2.5, 3.5]) * scale      # half-way codes
    jg, je = JS._compress_grads({k: jnp.asarray(v) for k, v in g.items()},
                                {k: jnp.asarray(v) for k, v in e.items()})
    pg = {("a",): LayerStack(torch.from_numpy(g["a"].copy()).unbind(0)),
          ("b",): torch.from_numpy(g["b"].copy())}
    pe = {"a": torch.from_numpy(e["a"].copy()), "b": torch.from_numpy(e["b"].copy())}
    got, ef = PS._compress_grads(pg, pe, inplace=False)
    assert np.array_equal(torch.stack(list(got[("a",)])).numpy(), np.asarray(jg["a"]))
    assert np.array_equal(got[("b",)].numpy(), np.asarray(jg["b"]))
    for k in ("a", "b"):
        assert np.array_equal(ef[k].numpy(), np.asarray(je[k])), k


def test_one_int8_code_apart_upstream_parts_the_embedding():
    """Why the ``ef`` cross-restore cases can miss their 99% on some hosts:
    from JAX's state after two compressed steps, the port's two further
    steps are deterministic (run twice, equal); but with one element of
    ``wk``'s error feedback moved by about one int8 step of its leaf -- so
    that its code is one apart, which is what a gradient differing in its
    last f32 bits gives at a rounding boundary -- every later gradient
    moves, ``embed.table``'s scale with them, and some of the table's
    params part by code-sized amounts, 100 times the checks' 1e-5 of
    max|p| (how many depends on the data and the host's sums: on an
    AVX-512 host the ``ef`` cases part in 1.1% and 5.7% of the table)."""
    cfg = _cfg()
    jstate, jstep = _jax_state(cfg, True)
    pipe = TokenPipeline(cfg.vocab_size, 2, 16, seed=1)
    for i in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
    base = jax.tree.map(np.asarray, jstate)
    step = _port_step(cfg, True)
    tables = []
    for nudge in (False, False, True):
        st = jax.tree.map(np.copy, base)
        if nudge:
            e = st.ef["groups"][0]["mix"]["wk"]["w"]
            e[0, 1, 4] += 2 * np.abs(e).max()
        s = convert.train_state_from_numpy(cfg, st, "cpu")
        for i in (2, 3):
            s, _ = step(s, pipe.batch_at(i))
        tables.append(convert.train_state_to_numpy(s)["params"]["embed"]["table"])
    assert np.array_equal(tables[0], tables[1])
    d = np.abs(tables[2] - tables[0])
    top = np.abs(tables[0]).max()
    assert d.max() > 1e-3 * top
    assert (d > 1e-5 * top).any()


def test_grads_from_an_identical_state_agree_to_f32_order():
    """From the same state (JAX's after two compressed steps) the port's
    gradient of ``embed.table`` is JAX's within 1e-6 of max|g| (the order
    of f32 sums), and one compressed step of each keeps every param of the
    table within 1e-5 of max|p|: the packages part only after chained
    steps, where such differences meet a rounding boundary (the test
    above)."""
    from repro_torch.train import step as PS

    cfg = _cfg()
    jstate, jstep = _jax_state(cfg, True)
    pipe = TokenPipeline(cfg.vocab_size, 2, 16, seed=1)
    jb = lambda i: {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
    for i in range(2):
        jstate, _ = jstep(jstate, jb(i))
    state = convert.train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), "cpu")

    def jloss(p):
        return JM.loss_fn(p, cfg, jb(2)["tokens"], jb(2)["labels"])[0]

    jg = np.asarray(jax.jit(jax.grad(jloss))(jstate.params)["embed"]["table"])
    _, pg = PS.value_and_grad(cfg, state.params, PS.as_batch(pipe.batch_at(2), "cpu"))
    assert np.abs(pg[("embed", "table")].numpy() - jg).max() <= 1e-6 * np.abs(jg).max()
    jnew, _ = jstep(jstate, jb(2))
    new, _ = _port_step(cfg, True)(state, pipe.batch_at(2))
    w = np.asarray(jnew.params["embed"]["table"])
    a = convert.train_state_to_numpy(new)["params"]["embed"]["table"]
    assert np.abs(a - w).max() <= 1e-5 * np.abs(w).max()
