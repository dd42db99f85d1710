"""The port's training path (``repro_torch.train``, ``models.model.loss_fn``,
``data.TokenPipeline``, ``launch.train``) held to the JAX package on the
CPU.

Both packages start from the same numbers: the JAX package's
``init_params(PRNGKey(0))`` read out as numpy and loaded with
``convert.lm_params_from_numpy`` (a whole ``TrainState`` with
``convert.train_state_from_numpy``), the same ``TokenPipeline`` batches.
Smoke configs run in float32.  Tolerances, because only the order of f32
sums differs: loss within rtol 1e-5; each gradient within 1e-4 x max|grad|
of its JAX leaf; the optimizers on identical gradients: new params within
1e-6 of max|JAX| of each leaf in f32 and within one bfloat16 ulp in bf16,
their state within rtol 1e-5 (atol 1e-6 of max|JAX|).  The
int8 gradient compression rounds ``g / scale`` to the nearest code, so an
element within f32 noise of a rounding boundary may take the neighbouring
code in the other package: the train steps with compression hold loss and
``grad_norm`` within 1e-4, and each leaf's residuals to the same scale
(half its quantum).  AdamW's first update is sign-like (m^ / sqrt(v^) = sign(g)), so
params are compared after one update only (step 1: the warmup gives step 0
lr 0).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as JPipe
from repro.models import blocks as JB
from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro import train as JT
from repro.train import optim as JOPT
from repro_torch import configs, convert
from repro_torch import train as T
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = sorted(configs.names())
BATCH, SEQ = 2, 16
GRAD_RTOL = 1e-4

# tests/test_substrates.py's config, in both packages
SUB = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
           d_ff=64, vocab_size=64, param_dtype="float32",
           compute_dtype="float32", remat=True)


def f32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


def jax_params(cfg):
    return jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)


def batch_of(cfg, batch=BATCH, seq=SEQ, step=0):
    """A pipeline batch with part of the mask off, and for a prefix-LM its
    prefix embeddings."""
    b = TokenPipeline(cfg.vocab_size, batch, seq, seed=3).batch_at(step)
    b["mask"][0, :3] = 0.0
    if cfg.prefix_lm:
        b["prefix_embeds"] = np.random.default_rng(2).standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return b


def jloss(cfg, b):
    def f(p):
        return JM.loss_fn(p, cfg, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]),
                          mask=jnp.asarray(b["mask"]),
                          prefix_embeds=None if "prefix_embeds" not in b
                          else jnp.asarray(b["prefix_embeds"]))
    return f


def port_value_and_grad(model, cfg, b):
    """(loss, aux, {path: stacked numpy grad}) by autograd."""
    leaves = M.param_leaves(model)
    flat = [t for v in leaves.values() for t in T.optim.rows(v)]
    for t in flat:
        t.requires_grad_(True)
    t_ = lambda k: None if k not in b else torch.as_tensor(b[k])
    loss, extra = M.loss_fn(model, cfg, t_("tokens"), t_("labels"),
                            mask=t_("mask"), prefix_embeds=t_("prefix_embeds"))
    gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    out = {}
    for path, v in leaves.items():
        got = [next(gs) for _ in T.optim.rows(v)]
        got = [np.zeros(tuple(t.shape), np.float32) if g is None else g.numpy()
               for g, t in zip(got, T.optim.rows(v))]
        out[path] = np.stack(got) if isinstance(v, M.LayerStack) else got[0]
    for t in flat:
        t.requires_grad_(False)
    return float(loss.detach()), float(extra["aux"].detach()), out


def leaf(tree, path):
    for q in path:
        tree = tree[q]
    return np.asarray(tree)


# -- data ----------------------------------------------------------------------


@pytest.mark.parametrize("args", [(64, 4, 16, 7, 123), (49155, 2, 64, 0, 0),
                                  (128, 3, 33, 5, 9)])
def test_pipeline_bitwise_equal_to_jax(args):
    vocab, batch, seq, seed, step = args
    got = TokenPipeline(vocab, batch, seq, seed=seed).batch_at(step)
    want = JPipe(vocab, batch, seq, seed=seed).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    it = iter(TokenPipeline(vocab, batch, seq, seed=seed))
    first = next(it)
    assert np.array_equal(first["tokens"], JPipe(vocab, batch, seq, seed=seed)
                          .batch_at(0)["tokens"])


# -- loss ----------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    want = JB.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = B.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                          None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an all-zero mask divides by max(0, 1): the loss is 0, not NaN
    zero = B.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                           torch.zeros(3, 7))
    assert float(zero) == 0.0


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    """``loss_fn`` and its gradients on every smoke config: MoE aux (dbrx,
    deepseek), MTP (deepseek), the vision prefix (paligemma), SSD (mamba2),
    RG-LRU (recurrentgemma), sliding windows and softcaps as configured."""
    cfg = f32(configs.get_smoke(name))
    jp = jax_params(cfg)
    b = batch_of(cfg)
    (want, jaux), jg = jax.jit(jax.value_and_grad(jloss(cfg, b), has_aux=True))(jp)
    model = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    got, aux, grads = port_value_and_grad(model, cfg, b)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(aux, float(jaux["aux"]), rtol=1e-5, atol=1e-9)
    if name == "deepseek-v3-671b":
        assert any(p[0] == "mtp" for p in grads)
    jflat = {tuple(getattr(q, "key", getattr(q, "idx", None)) for q in path): x
             for path, x in jax.tree_util.tree_leaves_with_path(jg)}
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        w = np.asarray(jflat[path])
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_RTOL * scale, f"{name} {path}: {err} vs {scale}"


def test_loss_chunks_follow_the_jax_rule():
    """The CE over sequence chunks: 4 chunks of 4 when loss_chunk divides
    S, one chunk when it does not; both equal the unchunked loss and JAX's."""
    cfg = f32(configs.get_smoke("granite-3-8b"))
    jp = jax_params(cfg)
    b = batch_of(cfg)
    model = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    args = (torch.as_tensor(b["tokens"]), torch.as_tensor(b["labels"]))
    with torch.no_grad():
        full = float(M.loss_fn(model, cfg, *args, mask=torch.as_tensor(b["mask"]))[0])
        for chunk in (4, 5, 16):
            got = float(M.loss_fn(model, cfg, *args, mask=torch.as_tensor(b["mask"]),
                                  loss_chunk=chunk)[0])
            want = float(JM.loss_fn(jp, cfg, jnp.asarray(b["tokens"]),
                                    jnp.asarray(b["labels"]),
                                    mask=jnp.asarray(b["mask"]), loss_chunk=chunk)[0])
            np.testing.assert_allclose(got, want, rtol=1e-5)
            np.testing.assert_allclose(got, full, rtol=1e-5)
        # no mask: every token counts
        nomask = float(M.loss_fn(model, cfg, *args)[0])
        want = float(JM.loss_fn(jp, cfg, jnp.asarray(b["tokens"]),
                                jnp.asarray(b["labels"]))[0])
    np.testing.assert_allclose(nomask, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["granite-3-8b", "dbrx-132b", "mamba2-370m",
                                  "recurrentgemma-9b", "deepseek-v3-671b"])
def test_remat_gives_the_same_grads(name):
    """Each layer under torch.utils.checkpoint (cfg.remat) against no remat:
    the recompute gives the same forward values, so the same gradients."""
    cfg = f32(configs.get_smoke(name))
    tree = jax.tree.map(np.asarray, jax_params(cfg))
    b = batch_of(cfg)
    out = {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        out[remat] = port_value_and_grad(convert.lm_params_from_numpy(c, tree, "cpu"),
                                         c, b)
    assert out[True][0] == out[False][0]
    for path, g in out[True][2].items():
        np.testing.assert_array_equal(g, out[False][2][path], err_msg=str(path))


def test_remat_recomputes_under_backward(monkeypatch):
    """With remat the forward keeps one saved input a layer: the layers run
    again inside the backward pass."""
    cfg = f32(configs.get_smoke("granite-3-8b"))
    model = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jax_params(cfg)),
                                         "cpu")
    calls = []
    forward = M.Layer.forward

    def counted(self, *a, **k):
        calls.append(1)
        return forward(self, *a, **k)

    monkeypatch.setattr(M.Layer, "forward", counted)
    b = batch_of(cfg)
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        port_value_and_grad(model, cfg.replace(remat=remat), b)
        assert len(calls) == want


# -- optimizers ------------------------------------------------------------------


def _grads_like(tree, seed, skew=False):
    """Random numpy grads of the tree's shapes; with ``skew`` each stacked
    leaf's layer 1 is sparse with large outliers, so its update's RMS
    differs from layer 0's and the per-leaf RMS clip is what is tested."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        g = rng.standard_normal(x.shape).astype(np.float32) * 1e-2
        if skew and path[0].key == "groups" and x.shape[0] > 1:
            g[1] *= np.where(rng.random(x.shape[1:]) < 0.05, 300.0, 1e-3)
        return g

    return jax.tree_util.tree_map_with_path(one, tree)


def _to_port_grads(model, tree):
    """The numpy grad tree as the port's leaves dict."""
    out = {}
    for path, v in M.param_leaves(model).items():
        a = leaf(tree, path)
        if isinstance(v, M.LayerStack):
            out[path] = M.LayerStack(torch.as_tensor(a[i]).to(v[0].dtype)
                                     for i in range(len(v)))
        else:
            out[path] = torch.as_tensor(a).to(v.dtype)
    return out


def _ulp_bf16(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(opt_name, dtype):
    """Two updates (steps 0 and 1) of each optimizer on identical grads,
    state carried between them: new params and state against JAX's."""
    cfg = configs.get_smoke("dbrx-132b").replace(param_dtype=dtype,
                                                 compute_dtype=dtype)
    jp = jax_params(cfg)
    host = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    model = convert.lm_params_from_numpy(cfg, host, "cpu")
    lr = T.warmup_cosine(1e-2, 1, 10)
    jopt = getattr(JT, opt_name)(JT.warmup_cosine(1e-2, 1, 10))
    topt = getattr(T, opt_name)(lr)
    jstate, tstate = jopt.init(jp), topt.init(model)
    params = M.param_leaves(model)
    for step in (0, 1):
        g = _grads_like(host, step, skew=True)
        jg = jax.tree.map(lambda a, p: jnp.asarray(a).astype(p.dtype), g, jp)
        jp, jstate = jax.jit(jopt.update)(jg, jstate, jp, jnp.int32(step))
        params, tstate = topt.update(_to_port_grads(model, g), tstate, params,
                                     torch.tensor(step, dtype=torch.int32))
        model = M.replace_params(model, params)
    for path, v in M.param_leaves(model).items():
        got = (torch.stack(list(v)) if isinstance(v, M.LayerStack) else v)
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy()
        want = np.asarray(leaf(jp, path).astype(jnp.float32))
        if dtype == "float32":
            err = np.abs(got - want).max()
            assert err <= 1e-6 * max(np.abs(want).max(), 1e-30), (path, err)
        else:
            assert (np.abs(got - want) <= _ulp_bf16(want)).all(), path
    jflat = jax.tree_util.tree_leaves_with_path(jstate)
    for path, want in jflat:
        keys = tuple(getattr(q, "key", getattr(q, "idx", None)) for q in path)
        got = T.optim.tree_get(tstate, keys).numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, keys
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-30),
                                   err_msg=str(keys))


def test_adafactor_clips_per_leaf_not_per_layer():
    """The update clipping's RMS runs over the whole stacked leaf: clipping
    each layer by its own RMS gives a different update, which JAX's is not."""
    cfg = f32(configs.get_smoke("granite-3-8b"))
    host = jax.tree.map(np.asarray, jax_params(cfg))
    model = convert.lm_params_from_numpy(cfg, host, "cpu")
    g = _grads_like(host, 0, skew=True)
    opt = T.adafactor(lambda s: torch.tensor(1e-2))
    new, _ = opt.update(_to_port_grads(model, g), opt.init(model),
                        M.param_leaves(model), torch.tensor(0, dtype=torch.int32))
    path = ("groups", 0, "ffn", "wi", "w")
    p0 = leaf(host, path)
    step_ = p0 - np.stack([t.numpy() for t in new[path]])
    # the two layers share one RMS scale: their update RMS is the leaf's
    # share, not 1 each
    rms = np.sqrt((step_ ** 2).mean(axis=(1, 2))) / 1e-2
    assert rms.max() > 1.01 * rms.min()
    assert np.sqrt(((step_ / 1e-2) ** 2).mean()) <= 1.0 + 1e-5


def test_adafactor_state_shapes_are_jaxs():
    cfg = configs.get_smoke("deepseek-v3-671b")
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    jstate = jax.eval_shape(JT.adafactor(JT.warmup_cosine(1e-3, 1, 2)).init, jp)
    model = M.init_params(cfg, None, "meta")
    state = T.adafactor(T.warmup_cosine(1e-3, 1, 2)).init(model)
    want = {tuple(getattr(q, "key", getattr(q, "idx", None)) for q in p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(jstate)}
    got = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            got[path] = tuple(t.shape)

    walk(state)
    assert got == want


def test_warmup_cosine_matches_jax():
    jf, tf = JT.warmup_cosine(3e-3, 5, 40), T.warmup_cosine(3e-3, 5, 40)
    for s in range(0, 45):
        np.testing.assert_allclose(float(tf(torch.tensor(s, dtype=torch.int32))),
                                   float(jf(jnp.int32(s))), rtol=1e-6, atol=1e-12)
    assert float(tf(torch.tensor(0, dtype=torch.int32))) == 0.0


def test_clip_by_global_norm_matches_jax():
    cfg = f32(configs.get_smoke("granite-3-8b"))
    host = jax.tree.map(np.asarray, jax_params(cfg))
    model = convert.lm_params_from_numpy(cfg, host, "cpu")
    g = _grads_like(host, 4)
    jg, jn = JOPT.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    tg, tn = T.clip_by_global_norm(_to_port_grads(model, g), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for path, v in tg.items():
        got = np.stack([t.numpy() for t in v]) if isinstance(v, M.LayerStack) else v.numpy()
        np.testing.assert_allclose(got, leaf(jg, path), rtol=1e-6, atol=1e-9)


# -- the train step ----------------------------------------------------------------


def _both_steps(opt_name, cfg, **kw):
    jopt = getattr(JT, opt_name)(JT.warmup_cosine(3e-3, 2, 10))
    topt = getattr(T, opt_name)(T.warmup_cosine(3e-3, 2, 10))
    js = JT.init_train_state(jax_params(cfg), jopt,
                             compress=kw.get("compress_grads", False))
    ts = convert.train_state_from_numpy(cfg, jax.tree.map(np.asarray, js), "cpu")
    return (js, jax.jit(JT.build_train_step(cfg, jopt, **kw)),
            ts, T.build_train_step(cfg, topt, **kw))


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("kw", [{"grad_accum": 2}, {"compress_grads": True}],
                         ids=["accum2", "int8"])
def test_train_step_matches_jax(opt_name, kw):
    """Three steps of build_train_step in both packages from one state on
    the same batches: loss and grad_norm each step, the error-feedback
    residuals carried over the three."""
    cfg = f32(configs.get_smoke("granite-3-8b"))
    js, jstep, ts, tstep = _both_steps(opt_name, cfg, **kw)
    pipe = TokenPipeline(cfg.vocab_size, 4, SEQ, seed=0)
    for i in range(3):
        b = pipe.batch_at(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4 if "compress_grads" in kw else 1e-5)
        assert int(tm["step"]) == int(jm["step"]) == i
    assert int(ts.step) == int(js.step) == 3
    if "compress_grads" in kw:
        got = convert.train_state_to_numpy(ts)["ef"]
        for path, want in jax.tree_util.tree_leaves_with_path(js.ef):
            keys = tuple(getattr(q, "key", getattr(q, "idx", None)) for q in path)
            a, w = leaf(got, keys), np.asarray(want)
            # each residual is within half a quantum of zero, the quantum
            # being the leaf's amax / 127 after three steps of feedback
            assert np.abs(a).max() > 0 and np.abs(w).max() > 0, keys
            np.testing.assert_allclose(np.abs(a).max(), np.abs(w).max(),
                                       rtol=0.05, err_msg=str(keys))
    else:
        assert ts.ef is None


def test_first_update_params_match_jax():
    """After step 1 (the first with lr > 0) the params of both packages
    agree within 1e-4 of max|p|: the sign-like first AdamW update moves
    each element by lr at most, and only near-zero grads can flip."""
    cfg = f32(configs.get_smoke("granite-3-8b"))
    js, jstep, ts, tstep = _both_steps("adamw", cfg)
    pipe = TokenPipeline(cfg.vocab_size, 4, SEQ, seed=0)
    for i in range(2):
        b = pipe.batch_at(i)
        js, _ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, _ = tstep(ts, b)
    got = convert.lm_params_to_numpy(ts.params)
    for path, want in jax.tree_util.tree_leaves_with_path(js.params):
        keys = tuple(getattr(q, "key", getattr(q, "idx", None)) for q in path)
        w = np.asarray(want)
        assert np.abs(leaf(got, keys) - w).max() <= 1e-4 * np.abs(w).max(), keys


def _snapshot(state):
    return [t.clone() for t in _tensors(state)]


def _tensors(state, step=True):
    out = [p for p in state.params.parameters()] + ([state.step] if step else [])

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif t is not None:
            out.append(t)

    walk(state.opt_state)
    walk(state.ef)
    return out


@pytest.mark.parametrize("compress", [False, True])
def test_default_step_leaves_its_input_alone(compress):
    cfg = f32(configs.get_smoke("granite-3-8b"))
    opt = T.adamw(T.warmup_cosine(3e-3, 1, 10))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = T.init_train_state(model, opt, compress=compress)
    step = T.build_train_step(cfg, opt, compress_grads=compress)
    b = batch_of(cfg)
    for _ in range(2):                     # step 1 has lr > 0
        before = _snapshot(state)
        new, m = step(state, b)
        for a, t in zip(before, _tensors(state)):
            assert torch.equal(a, t)
        assert new.params is not state.params
        assert not any(p.requires_grad for p in new.params.parameters())
        state = new
    assert int(state.step) == 2
    # the second step moved the params
    assert not all(torch.equal(a, b) for a, b in
                   zip(before[:3], list(state.params.parameters())[:3]))


def test_donated_step_updates_in_place():
    cfg = f32(configs.get_smoke("granite-3-8b"))
    opt = T.adafactor(T.warmup_cosine(3e-3, 1, 10))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = T.init_train_state(model, opt, compress=True)
    ref_step = T.build_train_step(cfg, opt, compress_grads=True)
    step = T.build_train_step(cfg, opt, compress_grads=True, donate=True)
    assert step.donate and not ref_step.donate
    b = batch_of(cfg)
    ptrs = [t.data_ptr() for t in _tensors(state, step=False)]
    want = state
    for _ in range(2):
        want, wm = ref_step(want, b)
        new, m = step(state, b)
        assert new.params is state.params and new.opt_state is state.opt_state
        assert new.ef is state.ef
        state = new
        assert float(m["loss"]) == float(wm["loss"])
    assert [t.data_ptr() for t in _tensors(state, step=False)] == ptrs
    for a, w in zip(_tensors(state), _tensors(want)):
        assert torch.equal(a, w)


def test_grad_shardings_raise():
    """A placement tree where one process holds every tile (the 1 x 1
    ``card`` mesh, a ``TileMesh``) gives the step without
    ``grad_shardings``, bit for bit; placements on two meshes raise.  (The
    step on a ``ProcessMesh``: tests/test_torch_meshtrain.py.)"""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_mesh

    cfg = f32(configs.get_smoke("granite-3-8b"))
    opt = T.adafactor(T.warmup_cosine(3e-3, 1, 10))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = batch_of(cfg)
    states, metrics = [], []
    for mesh in (None, SH.MESHES["card"], make_mesh((2, 2), ("data", "model"), "cpu")):
        gsh = None if mesh is None else SH.tree_named(mesh, model)
        state = T.init_train_state(M.replace_params(model, {
            k: T.optim.LayerStack(t.clone() for t in v) if isinstance(v, M.LayerStack)
            else v.clone() for k, v in M.param_leaves(model).items()}), opt)
        step = T.build_train_step(cfg, opt, grad_shardings=gsh)
        for _ in range(2):
            state, m = step(state, b)
        states.append(state)
        metrics.append(m)
    for state, m in zip(states[1:], metrics[1:]):
        assert all(torch.equal(m[k], metrics[0][k]) for k in m)
        for a, w in zip(_tensors(state), _tensors(states[0])):
            assert torch.equal(a, w)
    mixed = SH.tree_named(SH.MESHES["card"], model)
    mixed[next(iter(mixed))] = next(iter(SH.tree_named(SH.MESHES["single"], model).values()))
    with pytest.raises(ValueError, match="one mesh"):
        T.build_train_step(cfg, opt, grad_shardings=mixed)


# -- tests/test_substrates.py's training behaviours, on the port ------------------


@pytest.fixture(scope="module")
def sub():
    cfg = ModelConfig(**SUB)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pipe = TokenPipeline(cfg.vocab_size, batch=8, seq_len=16, seed=0)
    return cfg, params, pipe


def test_loss_decreases(sub):
    cfg, params, pipe = sub
    opt = T.adamw(T.warmup_cosine(3e-3, 5, 100))
    state = T.init_train_state(params, opt)
    step = T.build_train_step(cfg, opt, grad_accum=2)
    losses = []
    for i in range(25):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_adafactor_trains(sub):
    cfg, params, pipe = sub
    opt = T.adafactor(T.warmup_cosine(1e-2, 3, 50))
    state = T.init_train_state(params, opt)
    step = T.build_train_step(cfg, opt)
    for i in range(15):
        state, m = step(state, pipe.batch_at(i))
        if i == 0:
            l0 = float(m["loss"])
    assert float(m["loss"]) < l0
    # factored state is smaller than AdamW's
    af = sum(t.numel() for t in _tensors(state._replace(params=params))
             [len(list(params.parameters())) + 1:])
    aw = 2 * M.param_count(params)
    assert af < 0.2 * aw
    # and its tree is the JAX package's
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                               JModelConfig(**SUB)))
    jst = jax.eval_shape(JT.adafactor(JT.warmup_cosine(1e-2, 3, 50)).init, jp)
    assert af == sum(x.size for x in jax.tree.leaves(jst))


def test_compressed_grads_still_train(sub):
    cfg, params, pipe = sub
    opt = T.adamw(T.warmup_cosine(3e-3, 5, 100))
    state = T.init_train_state(params, opt, compress=True)
    step = T.build_train_step(cfg, opt, compress_grads=True)
    losses = []
    for i in range(20):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# -- launch.train ----------------------------------------------------------------


def _cli(argv, capsys):
    rc = train_cli.main(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out[out.index("{"):])


def test_cli_smoke_prints_the_jax_keys(capsys):
    rc, res = _cli(["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
                    "--steps", "4", "--batch", "2", "--seq", "16"], capsys)
    assert rc == 0
    assert {"arch", "steps", "loss_first", "loss_last", "mean_step_ms",
            "tokens_per_s"} <= set(res)
    assert res["arch"] == "granite-3-8b" and res["steps"] == 4
    assert len(res["losses"]) == len(res["step_ms"]) == 4
    assert res["loss_first"] == res["losses"][0] and np.isfinite(res["losses"]).all()


@pytest.mark.parametrize("argv", [["--optimizer", "adafactor", "--grad-accum", "2"],
                                  ["--compress-grads"]], ids=["adafactor", "int8"])
def test_cli_options(argv, capsys, tmp_path):
    rc, res = _cli(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--ckpt-dir", str(tmp_path), "--save-every", "2"] + argv, capsys)
    assert rc == 0 and res["steps"] == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002",
                                                          "step_00000003"]


def test_cli_mesh_exits_2_and_the_default_device_is_cuda(capsys):
    for mesh in ("single", "multi"):
        with pytest.raises(SystemExit) as exc:
            train_cli.main(["--arch", "granite-3-8b", "--smoke", "--mesh", mesh,
                            "--device", "cpu"])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert f"needs {256 * (1 + (mesh == 'multi'))} ranks" in err
        assert "no process group and no torchrun environment" in err
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--arch", "nope", "--device", "cpu"])
    assert exc.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(["--arch", "granite-3-8b", "--smoke", "--steps", "1"])


def cli_losses(cfg, argv, capsys, monkeypatch):
    """Both launchers' closing JSON, printed step losses (``printed``) and
    every step's loss (``losses``) on ``argv`` (``--smoke`` or the arch's
    name standing for ``cfg``): the JAX CLI as it is, its jitted step
    wrapped to read each loss; the port's with ``--device cpu``, starting
    from the JAX CLI's initial params (``init_params(PRNGKey(0))`` through
    ``convert``), because the two generators differ."""
    import re
    import types

    import repro.configs as jconfigs
    from repro.launch import train as jax_train_cli

    for mod in (jconfigs, configs):
        monkeypatch.setattr(mod, "get_smoke", lambda name: cfg)
        monkeypatch.setattr(mod, "get", lambda name: cfg)
    start = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jax_params(cfg)), "cpu")
    monkeypatch.setattr(M, "init_params", lambda c, gen, dev: start)
    jax_losses = []

    def jit(fn, **kw):
        step = jax.jit(fn, **kw)

        def run(state, batch):
            state, m = step(state, batch)
            jax_losses.append(float(m["loss"]))
            return state, m
        return run

    monkeypatch.setattr(jax_train_cli, "jax", types.SimpleNamespace(
        jit=jit, random=jax.random, device_put=jax.device_put))
    out = {}
    for side, main, extra in (("jax", jax_train_cli.main, []),
                              ("port", train_cli.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        text = capsys.readouterr().out
        res = json.loads(text[text.index("{"):])
        res["printed"] = {int(i): float(v) for i, v in
                          re.findall(r"^step +(\d+) loss (\S+)", text, re.M)}
        out[side] = res
    out["jax"]["losses"] = jax_losses
    return out["jax"], out["port"]


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_cli_losses_match_jax(opt_name, capsys, monkeypatch):
    """``launch.train --smoke`` for 6 steps at the launcher's lr 3e-3 in
    both packages from the same params, f32: loss_first, loss_last, the
    printed step losses and every step's loss within the loss tolerance,
    rtol 1e-5."""
    cfg = f32(configs.get_smoke("granite-3-8b"))
    argv = ["--arch", "granite-3-8b", "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "16", "--optimizer", opt_name]
    jres, res = cli_losses(cfg, argv, capsys, monkeypatch)
    assert res["steps"] == jres["steps"] == len(jres["losses"]) == 6
    assert sorted(res["printed"]) == sorted(jres["printed"]) == [0, 5]
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(res[k], jres[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-5)
    for i, want in jres["printed"].items():
        # both print four decimals of the same loss
        assert abs(res["printed"][i] - want) <= 1e-4


@pytest.mark.parametrize("opt_name", ["adafactor", "adamw"])
def test_cli_losses_full_width(opt_name, capsys, monkeypatch):
    """granite-3-8b at its published width and dtype (bf16), cut to 2
    layers, through both launchers at lr 3e-3 for 5 steps (2 x 32 tokens).

    The first loss (the same params and batch; bf16 arithmetic in another
    order) agrees within 1e-3.  Adafactor: the JAX CLI's params turn NaN
    at step 0 (lr 0) because XLA's CPU backend flushes f32 denormals to
    zero: after clipping, an embedding row whose grads are all 0 has
    v_est = vr * vc / denom ~ 1e-30 * 3e-10, flushed to 0, so u = 0 / 0.
    Run under ``torch.set_flush_denormal(True)`` the port's CLI gives the
    same NaN from step 1 on; with denormals kept (the default on the CPU
    and on the card) its losses stay finite.  AdamW has no such product:
    the step losses agree within 5e-3 (bf16 in another order).  At lr
    3e-3 the loss rises in both packages, to more than twice the first by
    step 4.  About 10 GB and several minutes on the CPU, so it runs only with
    REPRO_TORCH_FULL_WIDTH=1."""
    import os

    if os.environ.get("REPRO_TORCH_FULL_WIDTH") != "1":
        pytest.skip("full-width CPU run: set REPRO_TORCH_FULL_WIDTH=1")
    cfg = configs.get("granite-3-8b").replace(n_layers=2)
    argv = ["--arch", "granite-3-8b", "--steps", "5", "--batch", "2", "--seq",
            "32", "--optimizer", opt_name]
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    try:
        jres, res = cli_losses(cfg, argv, capsys, monkeypatch)
        if opt_name == "adafactor":
            torch.set_flush_denormal(True)
            _, ftz = cli_losses(cfg, argv, capsys, monkeypatch)
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(1)
    with capsys.disabled():
        print(f"\nfull-width granite-3-8b, 2 layers, bf16, {opt_name} lr 3e-3: "
              f"jax losses {jres['losses']}, port losses {res['losses']}"
              + (f", port flushing denormals {ftz['losses']}"
                 if opt_name == "adafactor" else ""))
    np.testing.assert_allclose(res["loss_first"], jres["loss_first"], rtol=1e-3)
    assert np.isfinite(res["losses"]).all()
    if opt_name == "adafactor":
        assert not np.isfinite(jres["losses"][1:]).any()
        np.testing.assert_allclose(ftz["loss_first"], jres["loss_first"], rtol=1e-3)
        assert not np.isfinite(ftz["losses"][1:]).any()
    else:
        # bf16 in another summation order: measured within 1.3e-3
        np.testing.assert_allclose(res["losses"], jres["losses"], rtol=5e-3)
    # at lr 3e-3 the loss rises in both packages
    for r in (jres, res) if opt_name == "adamw" else (res,):
        assert r["losses"][-1] > 2 * r["losses"][0]
