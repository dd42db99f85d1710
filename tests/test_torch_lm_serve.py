"""The port's LM serving (``serve.generate``, ``serve.SlotServer``,
``launch.serve --arch``) held to the JAX package on the CPU.

Both packages run every architecture's smoke config in float32 from the
same weights (the JAX package's ``init_params(PRNGKey(0))``, loaded with
``convert.lm_params_from_numpy``) on the same prompts from
``default_rng(1)``: greedy ``generate`` gives JAX's tokens, and a
``SlotServer`` fed the same schedule (two requests, two steps, a third
request mid-flight, then drained) completes the same requests with the
same tokens -- its quirks included, the batch-1 prefill spliced into a
free slot and one shared position a step.  The CLI prints the JAX
package's JSON keys for every architecture; an unknown one exits
non-zero naming it; ``--device cuda`` without a card raises.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jax_serve_cli
from repro.models import model as JM
from repro.serve import SlotServer as JSlotServer
from repro.serve import generate as jgenerate
from repro_torch import configs, convert
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.serve import SlotServer, generate
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = sorted(configs.names())
BATCH, PROMPT, STEPS = 2, 12, 6
# (request, prompt length, tokens to generate); the third joins after two
# steps, at another prompt length: the shared position is the largest
SCHEDULE = ((0, 10, 5), (1, 14, 7), (2, 8, 4))
SLOTS, SLOT_LEN = 3, 32
KEYS = {"arch", "batch", "gen", "wall_s", "tokens_per_s",
        "slot_server_completed"}


def f32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(name):
        if name not in cache:
            cfg = f32(configs.get_smoke(name))
            jp = jax.jit(JM.init_params, static_argnums=1)(
                jax.random.PRNGKey(0), cfg)
            cache[name] = (cfg, jp, jax.tree.map(np.asarray, jp))
        return cache[name]

    return get


def prompts(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape)


@pytest.mark.parametrize("name", ARCHS)
def test_generate_greedy_matches_jax(name, weights):
    cfg, jp, tree = weights(name)
    toks = prompts(cfg, (BATCH, PROMPT))
    want = np.asarray(jax.jit(lambda p, t: jgenerate(p, cfg, t, steps=STEPS))(
        jp, jnp.asarray(toks, jnp.int32)))
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    got = generate(params, cfg, torch.as_tensor(toks), steps=STEPS)
    assert got.shape == (BATCH, STEPS)
    assert np.array_equal(got.numpy(), want)


def _drain(srv, cfg, to_np):
    """Run SCHEDULE through ``srv``: {request id: tokens}."""
    done = {}
    ps = {rid: prompts(cfg, (n,), seed=10 + rid) for rid, n, _ in SCHEDULE}
    for rid, _, gen in SCHEDULE[:2]:
        assert srv.submit(to_np(ps[rid]), gen) == rid
    for _ in range(2):
        done.update(srv.step())
    rid, _, gen = SCHEDULE[2]
    assert srv.submit(to_np(ps[rid]), gen) == rid
    while len(done) < len(SCHEDULE):
        done.update(srv.step())
    return {k: [int(t) for t in v] for k, v in done.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_slot_server_matches_jax(name, weights):
    cfg, jp, tree = weights(name)
    want = _drain(JSlotServer(jp, cfg, batch_slots=SLOTS, max_len=SLOT_LEN),
                  cfg, lambda a: np.asarray(a, np.int32))
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    srv = SlotServer(params, cfg, batch_slots=SLOTS, max_len=SLOT_LEN)
    got = _drain(srv, cfg, np.asarray)
    assert got == want
    assert sorted(len(v) for v in got.values()) == sorted(
        g + 1 for _, _, g in SCHEDULE)
    assert all(s.req_id is None for s in srv.slots)


def test_generate_sampling_is_seeded():
    cfg = f32(configs.get_smoke("granite-3-8b"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(prompts(cfg, (BATCH, PROMPT)))

    def sample(seed):
        return generate(params, cfg, toks, steps=STEPS, temperature=0.8,
                        generator=torch.Generator().manual_seed(seed))

    a, b = sample(3), sample(3)
    assert torch.equal(a, b) and a.shape == (BATCH, STEPS)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    assert not all(torch.equal(sample(s), a) for s in (4, 5, 6))
    greedy = generate(params, cfg, toks, steps=STEPS)
    cold = generate(params, cfg, toks, steps=STEPS, temperature=1e-4,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(cold, greedy)
    with pytest.raises(ValueError, match="steps"):
        generate(params, cfg, toks, steps=0)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    text = buf.getvalue()
    return json.loads(text[text.index("{"):])


@pytest.mark.parametrize("name", ARCHS)
def test_serve_cli_arch_prints_the_jax_keys(name):
    got = _cli(serve_cli.main, ["--arch", name, "--smoke", "--device", "cpu",
                                "--batch", "2", "--prompt-len", "8", "--gen",
                                "4", "--slots"])
    assert set(got) == KEYS
    assert got["arch"] == name and got["batch"] == 2 and got["gen"] == 4
    assert got["slot_server_completed"] == 2 and got["tokens_per_s"] > 0


def test_serve_cli_arch_keys_are_the_jax_clis():
    argv = ["--arch", "musicgen-large", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "3", "--slots"]
    want = _cli(jax_serve_cli.main, argv)
    got = _cli(serve_cli.main, argv + ["--device", "cpu"])
    assert set(got) == set(want) == KEYS
    for key in ("arch", "batch", "gen", "slot_server_completed"):
        assert got[key] == want[key], key
    # without --slots the key is left out, as in the JAX CLI's code
    got = _cli(serve_cli.main, argv[:-1] + ["--device", "cpu"])
    assert set(got) == KEYS - {"slot_server_completed"}


def test_serve_cli_unknown_arch_exits_naming_it(capsys):
    with pytest.raises(SystemExit) as ei:
        serve_cli.main(["--arch", "gemma-7b", "--smoke", "--device", "cpu"])
    assert ei.value.code != 0
    assert "gemma-7b" in capsys.readouterr().err


def test_serve_cli_arch_never_falls_back_to_the_cpu():
    """The default device is cuda: it serves on a card and raises without
    one, never running on the CPU."""
    argv = ["--arch", "granite-3-8b", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "2"]
    if torch.cuda.is_available():
        assert _cli(serve_cli.main, argv)["arch"] == "granite-3-8b"
        assert M.init_params(configs.get_smoke("granite-3-8b")).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(configs.get_smoke("granite-3-8b"))
