"""LM serving (prefill, decode and ``generate``) on a
``launch.mesh.ProcessMesh``, held to the JAX package's sharded serving
cells and to the port's one-process generation on the CPU.

One module fixture spawns 4 gloo ranks once on a 2x2 (``data``,
``model``) grid (``launch.procs``; the rank side is
``tests/meshserve_cases.py``), which run ``launch.serve.serve_on_mesh``:
the params placed by ``param_specs`` (``fsdp``, or ``nofsdp``), the caches
by ``cache_specs`` (their sequence over ``model``).  A JAX subprocess
with forced host devices runs the same cases on a 2x2
``jax.sharding.Mesh``: ``prefill`` and ``decode_step`` jitted with the
shardings ``repro.launch.dryrun.build_cell`` gives them, under
``use_mesh_axes(..., seq_parallel=, ep_stationary=)``, from the port's
seed-0 params handed over as numpy, greedy on the same prompts.  Each
case is an f32 smoke config, 4 prompts of 16 tokens, 8 tokens
(``meshserve_cases.CASES``):

* the tokens equal both references', exactly;
* each step's last logits within 1e-4 of max|logit| of both, the ranks'
  (gathered whole) bitwise equal;
* each cache leaf after the last step, gathered, within 1e-5 of the max
  of the leaf of both (int8 codes equal);
* the wire bytes of the prefill and of every decode step equal to
  ``roofline.collect.serve_step_bytes``, call by call;
* the bytes each rank holds equal to ``device_bytes`` of ``param_specs``
  plus ``cache_specs``;
* sampling at a temperature draws the one-process run's ids: the ranks
  of a row the same, each batch shard its own rows' (no two shards share
  a uniform).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import meshserve_cases as C
from repro_torch import convert
from repro_torch.launch import procs
from repro_torch.launch import sharding as SH
from repro_torch.launch.dryrun import _parse_variant
from repro_torch.models import model as M
from repro_torch.roofline.collect import serve_step_bytes
from test_torch_dist_cases import run_jax
from torch_threads import one_torch_thread  # noqa: F401

DEADLINE_S = 300.0

_JAX = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs as jconfigs
from repro.launch import sharding as SH
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.models import shard
import meshserve_cases as C

A = json.load(open(sys.argv[1]))
init = np.load(A["init"])
res, js = {}, {}

def key(path):
    return "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)

mesh = make_mesh(C.GRID, C.AXES)
baxes = ("data",)
for cid, (arch, variant, _, widths) in C.CASES.items():
    cfg = jconfigs.get_smoke(arch).replace(param_dtype="float32", compute_dtype="float32",
                                           **widths)
    var = variant.split(",")
    if "int8kv" in var:
        cfg = cfg.replace(kv_cache_dtype="int8")
    if "nofsdp" in var:
        cfg = cfg.replace(fsdp=False)
    sp, ep = "sp" in var, "ep" in var
    max_len = C.max_len(cid)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(init[f"{cid}/{key(p)}"]), shapes)
    p_sh = SH.named(mesh, SH.param_specs(shapes, fsdp=cfg.fsdp, mesh=mesh,
                                         ep_stationary=ep), shapes)
    tok = jax.ShapeDtypeStruct((C.BATCH, C.PROMPT), jnp.int32)
    tok_sh = SH.named(mesh, SH.batch_specs(tok, baxes), tok)
    tok1 = jax.ShapeDtypeStruct((C.BATCH, 1), jnp.int32)
    tok1_sh = SH.named(mesh, SH.batch_specs(tok1, baxes), tok1)
    caches_sds = jax.eval_shape(lambda: JM.init_caches(cfg, C.BATCH, max_len))
    c_sh = SH.named(mesh, SH.cache_specs(caches_sds, baxes, cfg.seq_shard_decode),
                    caches_sds)
    prefill = jax.jit(lambda p, t: JM.prefill(p, cfg, tokens=t, max_len=max_len)[:2],
                      in_shardings=(p_sh, tok_sh), out_shardings=(None, c_sh))
    decode = jax.jit(lambda p, c, t, pos: JM.decode_step(p, cfg, c, t, pos),
                     in_shardings=(p_sh, c_sh, tok1_sh, None),
                     out_shardings=(None, c_sh), donate_argnums=(1,))
    prompts = jnp.asarray(C.prompts(cfg), jnp.int32)
    with shard.use_mesh_axes(mesh, baxes, "model", seq_parallel=sp, ep_stationary=ep):
        params = jax.device_put(params, p_sh)
        lg, caches = prefill(params, prompts)
        logits = [np.asarray(lg[:, -1])]
        t = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks = [np.asarray(t)]
        for i in range(C.GEN - 1):
            lg, caches = decode(params, caches, t, jnp.int32(C.PROMPT + i))
            logits.append(np.asarray(lg[:, -1]))
            t = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(t))
    res[f"{cid}/tokens"] = np.concatenate(toks, 1)
    res[f"{cid}/logits"] = np.stack(logits)
    for p, v in jax.tree_util.tree_leaves_with_path(caches):
        res[f"{cid}/cache/{key(p)}"] = np.asarray(v)
np.savez(sys.argv[2], json=json.dumps(js), **res)
print("JAX_MESHSERVE_DONE")
"""


def _flat(tree, prefix=()) -> dict:
    """path -> leaf of a nested dict/list numpy tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, prefix + (i,)).items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's arrays, the ranks' results, the one-process port's)."""
    tmp = tmp_path_factory.mktemp("meshserve")
    init = {}
    for cid in C.CASES:
        for path, v in _flat(convert.lm_params_to_numpy(C.seed_params(cid))).items():
            init[cid + "/" + "/".join(map(str, path))] = v
    np.savez(tmp / "init.npz", **init)
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(run_jax, _JAX, {"init": str(tmp / "init.npz")},
                            tmp / "jax.npz")
        ranks = procs.run(C.rank_main, 4, (), backend="gloo", device="cpu",
                          timeout_s=DEADLINE_S)
        one = {cid: C.one_process(cid) for cid in C.CASES}
        one["sampled"] = C.one_process_sampled()
        jax_side, _ = jax_run.result()
    return jax_side, ranks, one


CASE_IDS = list(C.CASES)
GRID = SH.MeshShape(dict(zip(C.AXES, C.GRID)))


@pytest.mark.parametrize("cid", CASE_IDS)
def test_tokens_equal_jax_and_one_process(sides, cid):
    jax_side, ranks, one = sides
    for r in ranks:
        got = r["cases"][cid]["tokens"]
        assert got.shape == (C.BATCH, C.GEN)
        np.testing.assert_array_equal(got, jax_side[f"{cid}/tokens"])
        np.testing.assert_array_equal(got, one[cid]["tokens"])


@pytest.mark.parametrize("cid", CASE_IDS)
def test_logits_match_and_ranks_agree(sides, cid):
    jax_side, ranks, one = sides
    got = np.stack(ranks[0]["cases"][cid]["logits"])
    assert got.shape == (C.GEN, C.BATCH, C.served_cfg(cid).vocab_size)
    for want in (jax_side[f"{cid}/logits"], np.stack(one[cid]["logits"])):
        for step, (a, w) in enumerate(zip(got, want)):
            assert np.abs(a - w).max() <= 1e-4 * np.abs(w).max(), step
    for r in ranks[1:]:
        assert np.array_equal(np.stack(r["cases"][cid]["logits"]), got)


@pytest.mark.parametrize("cid", CASE_IDS)
def test_caches_match_jax_and_one_process(sides, cid):
    jax_side, ranks, one = sides
    got = ranks[0]["cases"][cid]["caches"]
    assert set(got) == set(one[cid]["caches"])
    for path, a in got.items():
        for w in (one[cid]["caches"][path], jax_side[f"{cid}/cache/{path}"]):
            assert a.shape == w.shape and a.dtype == w.dtype, path
            assert np.abs(a.astype(np.float64) - w).max() <= \
                1e-5 * max(np.abs(w).max(), 1e-30), path
    for r in ranks[1:]:
        assert all(np.array_equal(a, r["cases"][cid]["caches"][p]) for p, a in got.items())


@pytest.mark.parametrize("cid", CASE_IDS)
def test_wire_bytes_equal_serve_step_bytes(sides, cid):
    """The prefill's bytes and each decode step's (its input token's pick
    included), call by call, are ``collect``'s model of the case."""
    _, ranks, _ = sides
    cfg = C.served_cfg(cid)
    var = _parse_variant(C.CASES[cid][1])
    opts = {"seq_parallel": var["sp"], "ep_stationary": var["ep"],
            "max_len": C.max_len(cid)}
    params = M.init_params(cfg, None, "meta")
    pre = serve_step_bytes(cfg, params, GRID, "prefill", C.BATCH, C.PROMPT, **opts)
    dec = serve_step_bytes(cfg, params, GRID, "decode", C.BATCH, C.PROMPT, pick=True,
                           **opts)
    pre.pop("total_bytes"), dec.pop("total_bytes")
    if cid != "mamba2":
        assert dec["decode_combine"] > 0 and dec["q_gather"] > 0
    else:
        assert dec["conv_gather"] > 0
    if var["sp"]:
        assert {"sp_gather", "sp_scatter"} <= set(pre) and "tp_fwd" not in pre
    if C.CASES[cid][1] == "nofsdp":
        assert "param_gather" not in pre and "param_gather" not in dec
    for r in ranks:
        steps = r["cases"][cid]["wire_bytes"]
        assert len(steps) == C.GEN
        assert steps[0] == pre
        assert all(s == dec for s in steps[1:])


@pytest.mark.parametrize("cid", CASE_IDS)
def test_held_bytes_equal_device_bytes(sides, cid):
    _, ranks, _ = sides
    cfg = C.served_cfg(cid)
    params = M.init_params(cfg, None, "meta")
    ep = _parse_variant(C.CASES[cid][1])["ep"]
    c_leaves = SH.cache_leaves(M.init_caches(cfg, C.BATCH, C.max_len(cid), "meta"))
    want = (SH.device_bytes(SH.tree_leaves(params),
                            SH.param_specs(params, cfg.fsdp, GRID, ep), GRID)
            + SH.device_bytes(c_leaves, SH.cache_specs(c_leaves, ("data",)), GRID))
    for r in ranks:
        assert r["cases"][cid]["held_bytes"] == r["cases"][cid]["device_bytes"] == want


def test_sampling_agrees_along_model(sides):
    """A draw at temperature 1: the two ranks of each batch shard (one
    ``model`` pair) draw the same ids, from the logits gathered whole,
    and they are the one-process draw's rows of that shard: the shards
    take different uniforms of one stream, not the same ones."""
    _, ranks, one = sides
    want = np.array(one["sampled"])
    assert want.shape == (C.BATCH, C.GEN)
    half = C.BATCH // 2
    assert not np.array_equal(want[:half], want[half:])
    by_shard = {}
    for r in ranks:
        by_shard.setdefault(r["coords"][0], []).append(r["sampled"])
    assert len(by_shard) == 2
    for d, draws in by_shard.items():
        assert draws[0] == draws[1]
        np.testing.assert_array_equal(np.array(draws[0]), want[d * half:(d + 1) * half])
