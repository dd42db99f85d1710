"""The port's LM zoo (``repro_torch.models``, ``repro_torch.configs``)
held to the JAX package on the CPU.

Both packages compute from the same weights: ``init_params(PRNGKey(0))``
of the JAX package, read out as numpy and loaded with
``convert.lm_params_from_numpy``.  Every architecture's smoke config runs
in float32 (params and compute) on the same prompt ids from
``default_rng(1)`` (and, for the prefix-LM, prefix embeddings from
``default_rng(2)``).  Tolerances, because only the order of f32 sums
differs: logits within rtol 1e-4 / atol 1e-5 (``np.testing.
assert_allclose``); greedy tokens, MoE drop masks and config fields
equal; int8 KV codes equal except where JAX's code sits within 1e-3 of a
rounding boundary (there within one); a bfloat16 run within 5e-2 of
max|JAX| (bf16 keeps 8 bits of mantissa; the two sides round different
partial sums).  The JAX side of each architecture runs once per module
(``jax_run``), jitted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import frontends as JF
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import ssm as JS
from repro_torch import configs, convert
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import frontends as F
from repro_torch.models import model as M
from repro_torch.models import moe as MO
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = sorted(configs.names())
BATCH, SEQ, STEPS = 2, 24, 8
RTOL, ATOL = 1e-4, 1e-5


def f32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


def inputs(cfg, batch=BATCH, seq=SEQ):
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, seq))
    pfx = None
    if cfg.prefix_lm:
        pfx = np.random.default_rng(2).standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return toks, pfx


def as_jax(a):
    return None if a is None else jnp.asarray(a)


def as_torch(a):
    return None if a is None else torch.as_tensor(a)


def _jax_greedy(jp, cfg, toks, pfx, steps, max_len):
    """JAX prefill then ``steps`` greedy decode steps: prefill logits and
    caches, each step's logits, the tokens fed (B, steps)."""
    pre = jax.jit(lambda p, t, f: JM.prefill(p, cfg, tokens=t, prefix_embeds=f,
                                             max_len=max_len))
    dec = jax.jit(lambda p, c, t, pos: JM.decode_step(p, cfg, c, t, pos))
    lg, caches, pos = pre(jp, jnp.asarray(toks), as_jax(pfx))
    out = {"prefill": np.asarray(lg),
           "caches": jax.tree.map(np.asarray, caches), "logits": [],
           "tokens": []}
    tok = jnp.argmax(lg[:, -1], -1)[:, None]
    for i in range(steps):
        out["tokens"].append(np.asarray(tok))
        lg, caches = dec(jp, caches, tok, pos + i)
        out["logits"].append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1)[:, None]
    out["tokens"] = np.concatenate(out["tokens"], 1)
    return out


def _run_jax(name):
    cfg = f32(configs.get_smoke(name))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    toks, pfx = inputs(cfg)
    h, aux = jax.jit(lambda p, t, f: JM.forward(p, cfg, tokens=t,
                                                prefix_embeds=f))(
        jp, jnp.asarray(toks), as_jax(pfx))
    run = {"cfg": cfg, "tree": jax.tree.map(np.asarray, jp), "toks": toks,
           "pfx": pfx, "forward": np.asarray(JM.logits_from_hidden(jp, cfg, h)),
           "aux": float(aux)}
    npfx = 0 if pfx is None else pfx.shape[1]
    run.update(_jax_greedy(jp, cfg, toks, pfx, STEPS, npfx + SEQ + STEPS))
    return run


@pytest.fixture(scope="module")
def jax_run():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_jax(name)
        return cache[name]

    return get


def port(run, cfg=None):
    return convert.lm_params_from_numpy(cfg or run["cfg"], run["tree"], "cpu")


def port_greedy(params, cfg, toks, pfx, feed, max_len):
    """Port prefill, then one decode step per column of ``feed``."""
    with torch.inference_mode():
        lg, caches, pos = M.prefill(params, cfg, tokens=as_torch(toks),
                                    prefix_embeds=as_torch(pfx), max_len=max_len)
        pre, first = lg.numpy(), convert.lm_caches_to_numpy(caches)
        logits = []
        for i in range(feed.shape[1]):
            lg, caches = M.decode_step(params, cfg, caches,
                                       torch.as_tensor(feed[:, i:i + 1]), pos + i)
            logits.append(lg.numpy())
    return pre, first, logits


# -- configs ------------------------------------------------------------------


def test_registry_is_the_jax_packages():
    assert configs.names() == jconfigs.names()
    assert configs.SHAPES == jconfigs.SHAPES


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_jax(name):
    got, want = configs.get(name), jconfigs.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())
    assert configs.cells(got) == jconfigs.cells(want)
    assert configs.subquadratic(got) == jconfigs.subquadratic(want)
    assert got.layer_groups() == want.layer_groups()
    assert got.n_params() == want.n_params() and got.hd == want.hd


@pytest.mark.parametrize("name", ARCHS)
def test_param_count_matches_jax(name):
    """Published configs, no weights built: the port on the meta device,
    JAX through eval_shape."""
    cfg = configs.get(name)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    model = M.init_params(cfg, None, "meta")
    assert M.param_count(model) == JM.param_count(shapes)
    got = sorted(tuple(p.shape) for p in model.parameters())
    want = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        stacked = path[0].key == "groups"
        n = leaf.shape[0] if stacked else 1
        want += [tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)] * n
    assert got == sorted(want)


# -- the whole model ----------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(name, jax_run):
    run = jax_run(name)
    cfg = run["cfg"]
    params = port(run)
    with torch.inference_mode():
        h, aux = M.forward(params, cfg, tokens=as_torch(run["toks"]),
                           prefix_embeds=as_torch(run["pfx"]))
        got = M.logits_from_hidden(params, cfg, h).numpy()
    np.testing.assert_allclose(got, run["forward"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), run["aux"], rtol=RTOL, atol=1e-9)
    # the param tree carries over both ways
    back = convert.lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(run["tree"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(run["tree"])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax(name, jax_run):
    """Prefill logits and caches, then eight decode steps fed JAX's greedy
    tokens: every step's logits, and the port's own greedy picks equal to
    JAX's."""
    run = jax_run(name)
    cfg = run["cfg"]
    npfx = 0 if run["pfx"] is None else run["pfx"].shape[1]
    pre, caches, logits = port_greedy(port(run), cfg, run["toks"], run["pfx"],
                                      run["tokens"], npfx + SEQ + STEPS)
    np.testing.assert_allclose(pre, run["prefill"], rtol=RTOL, atol=ATOL)
    assert jax.tree.structure(caches) == jax.tree.structure(run["caches"])
    for a, b in zip(jax.tree.leaves(caches), jax.tree.leaves(run["caches"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for i, lg in enumerate(logits):
        np.testing.assert_allclose(lg, run["logits"][i], rtol=RTOL, atol=ATOL)
    picks = np.concatenate([pre[:, -1].argmax(-1)[:, None]]
                           + [lg[:, -1].argmax(-1)[:, None] for lg in logits[:-1]], 1)
    assert np.array_equal(picks, run["tokens"])


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name, jax_run):
    """The serving invariant (the twin of tests/test_models.py::
    test_decode_matches_forward): prefill + eight decode steps equal
    forward on the whole sequence.  MoE prefill runs at a capacity that
    drops nothing (cf = E / k), as decode never drops."""
    run = jax_run(name)
    cfg = run["cfg"]
    if cfg.n_experts:
        cfg = cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.top_k)
    params = port(run, cfg)
    npfx = 0 if run["pfx"] is None else run["pfx"].shape[1]
    _, _, logits = port_greedy(params, cfg, run["toks"], run["pfx"],
                               run["tokens"], npfx + SEQ + STEPS)
    seq = np.concatenate([run["toks"], run["tokens"]], 1)
    with torch.inference_mode():
        h, _ = M.forward(params, cfg, tokens=torch.as_tensor(seq),
                         prefix_embeds=as_torch(run["pfx"]))
        ref = M.logits_from_hidden(params, cfg, h).numpy()
    for i, lg in enumerate(logits):
        want = ref[:, npfx + SEQ + i:npfx + SEQ + i + 1]
        err = np.abs(lg - want).max() / np.abs(want).max()
        assert err < 1e-4, f"{name} step {i}: {err}"


def test_bf16_smoke_close_to_jax():
    """granite-3-8b's smoke config in bfloat16 (params and compute), the
    published dtypes: the port's logits within 5e-2 x max|JAX|."""
    cfg = configs.get_smoke("granite-3-8b")
    assert cfg.param_dtype == cfg.compute_dtype == "bfloat16"
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    toks, _ = inputs(cfg)
    h, _ = JM.forward(jp, cfg, tokens=jnp.asarray(toks))
    want = np.asarray(JM.logits_from_hidden(jp, cfg, h).astype(jnp.float32))
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    assert params.embed.table.dtype == torch.bfloat16
    with torch.inference_mode():
        h, _ = M.forward(params, cfg, tokens=torch.as_tensor(toks))
        got = M.logits_from_hidden(params, cfg, h).float().numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


# -- the blocks -------------------------------------------------------------


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(),                                                  # one chunk
    dict(q_chunk=8, kv_chunk=8),                             # 3 x 3 tiles
    dict(q_chunk=7, kv_chunk=5, window=6),                   # padded tiles
    dict(q_chunk=8, kv_chunk=4, prefix_len=10),
    dict(q_chunk=8, kv_chunk=8, softcap=5.0, window=3),      # masked tiles
    dict(causal=False, kv_chunk=16),
    dict(q_chunk=4, kv_chunk=8, q_offset=8, sq=12),
], ids=["one-chunk", "tiles", "padded-window", "prefix", "softcap-window",
        "bidirectional", "q-offset"])
def test_flash_attention_matches_jax(case):
    case = dict(case)
    sq = case.pop("sq", 24)
    q, k, v = _rand((2, sq, 4, 16), 0), _rand((2, 24, 2, 16), 1), _rand((2, 24, 2, 16), 2)
    want = np.asarray(JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **case))
    got = A.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(v), **case).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_quantize_kv_matches_jax_bitwise():
    """The same inputs give JAX's int8 codes and scales exactly, exact .5
    ties rounding half to even as jnp.round does."""
    x = _rand((2, 16, 2, 16), 3) * 3
    x[0, 0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]    # scale 1.0: ties
    x[0, 0, 0, 6:] = 0.0
    x[1, 1, 1] = 0.0                                     # an all-zero head
    jq, js = JA.quantize_kv(jnp.asarray(x))
    q, s = A.quantize_kv(torch.as_tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(
        A.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(JA.dequantize_kv(jq, js, jnp.float32)))


def test_int8_kv_cache_matches_jax():
    """granite-3-8b's smoke config with an int8 KV cache: the prefilled
    codes equal JAX's (within one where JAX's code sits within 1e-3 of a
    rounding boundary), the scales and the decode logits within rtol
    1e-4; decode within 6e-2 of forward (tests/test_models.py::
    test_int8_kv_cache_close)."""
    cfg = f32(configs.get_smoke("granite-3-8b")).replace(kv_cache_dtype="int8")
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    toks, _ = inputs(cfg)
    want = _jax_greedy(jp, cfg, toks, None, 2, SEQ + 2)
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    pre, caches, logits = port_greedy(params, cfg, toks, None, want["tokens"],
                                      SEQ + 2)
    np.testing.assert_allclose(pre, want["prefill"], rtol=RTOL, atol=ATOL)
    for i, lg in enumerate(logits):
        np.testing.assert_allclose(lg, want["logits"][i], rtol=RTOL, atol=ATOL)
    got_c, want_c = caches[0], want["caches"][0]
    near_half = {}
    with torch.inference_mode():
        x = M._embed_tokens(params, cfg, torch.as_tensor(toks))
        kv = {"k": [], "v": []}
        for lay in params.groups[0]:
            h = lay.norm1(x)
            _, k, v = A._qkv(lay.mix, h, cfg, torch.arange(SEQ).expand(BATCH, SEQ))
            kv["k"].append(k)
            kv["v"].append(v)
            x, _ = lay(x, cfg)
    for name in ("k", "v"):
        t = torch.stack(kv[name]).float()
        r = (t / (torch.clamp(t.abs().amax(-1, keepdim=True), min=1e-8) / 127.0))
        frac = (r - torch.floor(r)).numpy()
        near_half[name] = np.abs(frac - 0.5) < 1e-3
    for name in ("k", "v"):
        g, w = got_c[name], want_c[name]
        assert g.dtype == w.dtype == np.int8
        np.testing.assert_allclose(got_c[name + "_s"], want_c[name + "_s"],
                                   rtol=RTOL, atol=0)
        # a code may differ by one only where x / scale sits within 1e-3
        # of k + 1/2 (the f32 keys differ in the last bits); x / scale is
        # recomputed from the port's own keys
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1
        assert not diff[:, :, SEQ:].any()               # slots not yet written
        diff = diff[:, :, :SEQ]
        assert np.array_equal(diff > 0, (diff > 0) & near_half[name])
    # decode against forward on the same tokens
    seq = np.concatenate([toks, want["tokens"][:, :1]], 1)
    with torch.inference_mode():
        h, _ = M.forward(params, cfg, tokens=torch.as_tensor(seq))
        ref = M.logits_from_hidden(params, cfg, h[:, -1:]).numpy()
    assert np.abs(logits[0] - ref).max() / np.abs(ref).max() < 6e-2


def test_swa_ring_slots_match_jax():
    """h2o-danube-1.8b's smoke config (window 32) prefilling 40 tokens: the
    ring holds tokens 8..39 at slots t % 32, as JAX's cache; eight decode
    steps wrap further and match JAX's logits."""
    cfg = f32(configs.get_smoke("h2o-danube-1.8b"))
    assert cfg.sliding_window == 32
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    toks, _ = inputs(cfg, seq=40)
    want = _jax_greedy(jp, cfg, toks, None, STEPS, 40 + STEPS)
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    pre, caches, logits = port_greedy(params, cfg, toks, None, want["tokens"],
                                      40 + STEPS)
    k = caches[0]["k"]                                   # (layers, B, 32, KV, D)
    assert k.shape[2] == 32
    np.testing.assert_allclose(k, want["caches"][0]["k"], rtol=RTOL, atol=ATOL)
    # slot t % 32 holds token t's key: recompute layer 0's keys directly
    with torch.inference_mode():
        lay = params.groups[0][0]
        x = M._embed_tokens(params, cfg, torch.as_tensor(toks))
        h = lay.norm1(x)
        pos = torch.arange(40).expand(2, 40)
        _, kk, _ = A._qkv(lay.mix, h, cfg, pos)
    for t in range(8, 40):
        np.testing.assert_allclose(k[0][:, t % 32], kk[:, t].numpy(),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pre, want["prefill"], rtol=RTOL, atol=ATOL)
    for i, lg in enumerate(logits):
        np.testing.assert_allclose(lg, want["logits"][i], rtol=RTOL, atol=ATOL)


def _jax_route(jp_moe, x, cfg, cap):
    """The JAX package's routing of ``moe_apply`` (src/repro/models/moe.py,
    the lines from the router logits to ``keep``), on JAX's arrays."""
    logits = JB.linear(jp_moe["router"], x).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    g, t = x.shape[0], x.shape[1]
    flat = jax.nn.one_hot(idx, cfg.n_experts, dtype=jnp.int32).reshape(
        g, t * cfg.top_k, cfg.n_experts)
    pos = jnp.sum(flat * (jnp.cumsum(flat, axis=1) - flat), axis=-1)
    return np.asarray(idx), np.asarray(pos < cap)


@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_drops_match_jax(name):
    """``moe_apply`` at capacity factor 0.6 (capacity 6 of 20 tokens x 2
    assignments over 4 experts): prefill drops exactly JAX's assignments
    (the ``keep`` mask, some dropped) and gives JAX's y and aux; decode
    (s = 1) keeps every assignment."""
    cf = 0.6
    cfg = f32(configs.get_smoke(name))
    jp = JMOE.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    p = MO.MoE(cfg, B.Init(None, "cpu", torch.float32))
    for pname, prm in p.named_parameters():
        node = jp
        for part in pname.split("."):
            node = node[part]
        with torch.no_grad():
            prm.copy_(torch.from_numpy(np.array(node)))
    for shape in ((3, 20, cfg.d_model), (5, 1, cfg.d_model)):
        x = _rand(shape, 4)
        jy, jaux = JMOE.moe_apply(jp, jnp.asarray(x), cfg, capacity_factor=cf)
        y, aux = MO.moe_apply(p, torch.as_tensor(x), cfg, capacity_factor=cf)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
        xg = x if shape[1] > 1 else x.reshape(1, shape[0], -1)
        cap = (MO.capacity(shape[1], cfg.top_k, cfg.n_experts, cf)
               if shape[1] > 1 else shape[0])
        idx, keep = _jax_route(jp, jnp.asarray(xg), cfg, cap)
        r = MO.route(p.router(torch.as_tensor(xg)), cfg.top_k, cap)
        assert np.array_equal(r["idx"].numpy(), idx)
        assert np.array_equal(r["keep"].numpy(), keep)
        if shape[1] > 1:
            assert 0 < (~keep).sum() < keep.size        # the drops are real
        else:
            assert keep.all()


def test_ssd_chunked_matches_jax():
    """The SSD core with a padded last chunk and an initial state."""
    bb, l, h, p, n = 2, 37, 3, 4, 5
    x, b, c = _rand((bb, l, h, p), 0), _rand((bb, l, n), 1), _rand((bb, l, n), 2)
    dt = np.abs(_rand((bb, l, h), 3)) * 0.3
    a = -np.abs(_rand((h,), 4)) - 0.1
    s0 = _rand((bb, h, p, n), 5)
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), 8,
                            init_state=jnp.asarray(s0))
    y, s = S.ssd_chunked(*map(torch.as_tensor, (x, dt, a, b, c)), 8,
                         init_state=torch.as_tensor(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


def test_linear_scan_matches_jax_associative_scan():
    a = np.random.default_rng(0).uniform(0.5, 1.0, (2, 37, 8)).astype(np.float32)
    b = _rand((2, 37, 8), 1)

    def combine(lft, rgt):
        return lft[0] * rgt[0], rgt[1] + rgt[0] * lft[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                       axis=1)
    got = R.linear_scan(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_norms_rope_and_mlps_match_jax():
    x = _rand((2, 6, 4, 16), 0)
    pos = np.arange(6)[None].repeat(2, 0)
    np.testing.assert_allclose(
        B.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4).numpy(),
        np.asarray(JB.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=RTOL, atol=ATOL)
    h = _rand((2, 6, 16), 1)
    scale, bias = _rand((16,), 2), _rand((16,), 3)
    np.testing.assert_allclose(
        B.rms_norm(torch.as_tensor(scale), torch.as_tensor(h)).numpy(),
        np.asarray(JB.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(h))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        B.layer_norm(torch.as_tensor(scale), torch.as_tensor(bias),
                     torch.as_tensor(h)).numpy(),
        np.asarray(JB.layer_norm({"scale": jnp.asarray(scale),
                                  "bias": jnp.asarray(bias)}, jnp.asarray(h))),
        rtol=RTOL, atol=ATOL)
    for act in ("swiglu", "geglu", "gelu"):
        jp = JB.init_mlp(jax.random.PRNGKey(0), 16, 32, act)
        p = B.MLP(16, 32, act, B.Init(None, "cpu", torch.float32))
        for name, prm in p.named_parameters():
            mod, leaf = name.split(".")
            with torch.no_grad():
                prm.copy_(torch.as_tensor(np.asarray(jp[mod][leaf])))
        np.testing.assert_allclose(
            p(torch.as_tensor(h)).detach().numpy(),
            np.asarray(JB.mlp(jp, jnp.asarray(h), act)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["paligemma-3b", "musicgen-large", "granite-3-8b"])
def test_frontend_matches_jax(name):
    cfg = f32(configs.get_smoke(name))
    jp = JF.init_frontend(jax.random.PRNGKey(0), cfg, jnp.float32)
    p = F.init_frontend(cfg, B.Init(None, "cpu", torch.float32))
    if not jp:
        assert list(p.parameters()) == []
        assert F.apply_frontend(p, None, cfg) is None
        return
    with torch.no_grad():
        p.proj.w.copy_(torch.as_tensor(np.asarray(jp["proj"]["w"])))
    feats = _rand((2, cfg.n_prefix_tokens or 4, p.proj.w.shape[0]), 0)
    np.testing.assert_allclose(
        F.apply_frontend(p, torch.as_tensor(feats), cfg).detach().numpy(),
        np.asarray(JF.apply_frontend(jp, jnp.asarray(feats), cfg)),
        rtol=RTOL, atol=ATOL)


def test_init_draws_the_jax_distributions():
    """init_params on the CPU from a seeded generator: every leaf of the
    JAX tree's shape and dtype, the same constants (norm scales 1, biases
    0, A_log, D), normal draws at JAX's scales; the same seed gives the
    same weights."""
    cfg = f32(configs.get_smoke("mamba2-370m"))
    a = M.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    mix = a.groups[0][0].mix
    np.testing.assert_allclose(mix.A_log.numpy(), np.log(np.linspace(1, 16, 8)),
                               rtol=1e-6)
    assert torch.all(mix.D == 1) and torch.all(mix.dt_bias == 0)
    assert abs(float(mix.conv_w.std()) - 0.2) < 0.05
    w = mix.in_proj.w
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1) < 0.1
    assert abs(float(a.embed.table.std()) - 0.02) < 0.002
    rg = M.init_params(f32(configs.get_smoke("recurrentgemma-9b")),
                       torch.Generator().manual_seed(0), "cpu")
    lam = rg.groups[0][0].l0.mix.lam
    assert float(lam.min()) >= 0.9 and float(lam.max()) <= 0.999
    with pytest.raises(ValueError, match="generator"):
        M.init_params(cfg, torch.Generator(), "meta")
