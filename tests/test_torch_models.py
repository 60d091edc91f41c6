"""Port parity for the LM substrate's forward and serving path, on the CPU.

For each of the ten architectures at smoke size: the JAX package's
parameters (`init_params(PRNGKey)`) go to the port as numpy arrays
(`params_from_numpy`), and the port's logits are held against the JAX
package's for the cache-free forward, the prefill step and three
teacher-forced decode steps, with numpy-made tokens and frontend stubs.
Both run in float32.  Tolerance: 1e-4 absolute (atol) with rtol 1e-4 —
the two frameworks sum float32 matmuls in different orders, a few ulps
of logits of order 1.  The port's own prefill/decode consistency uses
`tests/test_models.py`'s 2e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import lm as jax_lm
from repro.train import steps as jax_steps
from repro_torch.configs import ARCHS, get_config, get_smoke_config, shape_cells
from repro_torch.configs import input_specs
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.train import steps

ATOL = RTOL = 1e-4


def _inputs(cfg, B, S, seed):
    """numpy tokens and stubs, as the JAX package's and the port's inputs."""
    rng = np.random.default_rng(seed)
    np_in = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        np_in["patches"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        np_in["enc_embeds"] = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    jx = {k: jnp.asarray(v) for k, v in np_in.items()}
    pt = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
          for k, v in np_in.items()}
    return jx, pt


def _params(arch, seed=0):
    cfg = jax_get_smoke_config(arch)
    jp = jax_lm.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = lm.params_from_numpy(jax.tree.map(np.asarray, jp), get_smoke_config(arch), "cpu")
    return cfg, jp, tp


def _close(got, exp):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=RTOL, atol=ATOL)


def test_configs_are_the_reference_configs():
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
        assert (dataclasses.asdict(get_smoke_config(arch))
                == dataclasses.asdict(jax_get_smoke_config(arch)))
        from repro.configs import shape_cells as jax_shape_cells
        assert shape_cells(arch) == jax_shape_cells(arch)
    from repro.configs import input_specs as jax_input_specs
    specs = input_specs(get_config(ARCHS[0]), "train_4k")
    jspecs = jax_input_specs(jax_get_config(ARCHS[0]), "train_4k")
    assert list(specs) == list(jspecs)
    assert specs["tokens"].device.type == "meta"
    assert tuple(specs["tokens"].shape) == tuple(jspecs["tokens"].shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_reference(arch):
    full = get_config(arch)
    assert full.param_count() == jax_get_config(arch).param_count()
    assert full.active_param_count() == jax_get_config(arch).active_param_count()
    assert lm.param_count(full) == jax_lm.param_count(jax_get_config(arch))
    smoke = get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), smoke, torch.float32, "cpu")
    counted = sum(t.numel() for t in lm.tree_leaves(params))
    assert counted == lm.param_count(smoke) == jax_lm.param_count(jax_get_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jp, tp = _params(arch)
    jx, pt = _inputs(cfg, 2, 32, seed=1)
    exp, _ = jax_lm.forward(jp, cfg, tokens=jx["tokens"], patches=jx.get("patches"),
                            enc_embeds=jx.get("enc_embeds"))
    got, _ = lm.forward(tp, get_smoke_config(arch), tokens=pt["tokens"],
                        patches=pt.get("patches"), enc_embeds=pt.get("enc_embeds"))
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    _close(got, exp)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    """Prefill step, then three decode steps teacher-forced with the same
    tokens: every step's logits against the JAX package's step builders,
    each side carrying its own caches."""
    cfg, jp, tp = _params(arch, seed=2)
    tcfg = get_smoke_config(arch)
    S, n_dec = 20, 3
    jx, pt = _inputs(cfg, 2, S + n_dec, seed=3)
    jx_pre = {**jx, "tokens": jx["tokens"][:, :S]}
    pt_pre = {**pt, "tokens": pt["tokens"][:, :S]}
    exp, jc = jax_steps.make_prefill_step(cfg)(jp, jx_pre)
    got, tc = steps.make_prefill_step(tcfg)(tp, pt_pre)
    _close(got, exp)
    jdec, tdec = jax_steps.make_decode_step(cfg), steps.make_decode_step(tcfg)
    for i in range(n_dec):
        jb = {"tokens": jx["tokens"][:, S + i:S + i + 1]}
        tb = {"tokens": pt["tokens"][:, S + i:S + i + 1]}
        if cfg.is_enc_dec:
            jb["enc_embeds"], tb["enc_embeds"] = jx["enc_embeds"], pt["enc_embeds"]
        exp, jc = jdec(jp, jc, jb, pos=S + i)
        got, tc = tdec(tp, tc, tb, pos=S + i)
        _close(got, exp)
    # the caches the port carried hold what the JAX package's hold
    got_leaves = jax.tree.leaves(lm.tree_map(lambda t: t.numpy(), tc))
    exp_leaves = jax.tree.leaves(jc)
    assert len(got_leaves) == len(exp_leaves)
    for e, g in zip(exp_leaves, got_leaves):
        np.testing.assert_allclose(g, np.asarray(e), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(x[:-1]), x[-1]) matches forward(x) at the last
    position in the port, as tests/test_models.py holds the JAX package.
    The vision stub's patches overwrite the first 8 positions of both the
    full sequence and the prefill; the decoded token lies past them."""
    cfg = get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(1), cfg, torch.float32, "cpu")
    B, S = 2, 24
    _, pt = _inputs(cfg, B, S, seed=4)
    kw = {k: pt[k] for k in ("patches", "enc_embeds") if k in pt}
    kw_d = {k: v for k, v in kw.items() if k != "patches"}
    full, _ = lm.forward(params, cfg, tokens=pt["tokens"], **kw)
    cache0 = lm.make_cache(cfg, B, 0, torch.float32, "cpu")
    _, caches = lm.forward(params, cfg, tokens=pt["tokens"][:, :-1], caches=cache0, **kw)
    dec, _ = lm.forward(params, cfg, tokens=pt["tokens"][:, -1:], caches=caches,
                        pos=S - 1, **kw_d)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def test_local_window_cache_is_bounded():
    """gemma2-style local layers cap their cache at the window, through
    prefill and decode; global layers keep every position."""
    cfg = get_smoke_config("gemma2-27b")
    params = lm.init_params(torch.Generator().manual_seed(2), cfg, torch.float32, "cpu")
    B, S = 1, 64  # window is 16
    _, pt = _inputs(cfg, B, S + 1, seed=5)
    logits, caches = steps.make_prefill_step(cfg)(params, {"tokens": pt["tokens"][:, :S]})
    assert caches["units"][0]["k"].shape[2] == cfg.window     # slot 0 = local
    assert caches["units"][1]["k"].shape[2] == S              # slot 1 = global
    _, caches = steps.make_decode_step(cfg)(params, caches, {"tokens": pt["tokens"][:, S:]},
                                            pos=S)
    assert caches["units"][0]["k"].shape[2] == cfg.window
    assert caches["units"][1]["v"].shape[2] == S + 1


def test_params_from_numpy_refuses_a_wrong_layout():
    cfg, jp, _ = _params("starcoder2-3b")
    tree = jax.tree.map(np.asarray, jp)
    tree["units"][0]["attn"]["wq"] = tree["units"][0]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError):
        lm.params_from_numpy(tree, get_smoke_config("starcoder2-3b"), "cpu")
    with pytest.raises(ValueError):
        lm.params_from_numpy({"embed": tree["embed"]}, get_smoke_config("starcoder2-3b"), "cpu")


def test_caches_from_numpy_continues_a_reference_prefill():
    """A JAX prefill's caches, carried across, decode in the port to the
    JAX package's next logits."""
    cfg, jp, tp = _params("gemma3-27b", seed=3)
    jx, pt = _inputs(cfg, 2, 21, seed=6)
    _, jc = jax_steps.make_prefill_step(cfg)(jp, {"tokens": jx["tokens"][:, :20]})
    exp, _ = jax_steps.make_decode_step(cfg)(jp, jc, {"tokens": jx["tokens"][:, 20:]}, pos=20)
    tc = lm.caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    got, _ = steps.make_decode_step(get_smoke_config("gemma3-27b"))(
        tp, tc, {"tokens": pt["tokens"][:, 20:]}, pos=20)
    _close(got, exp)


def test_training_is_not_ported_yet():
    """What of training the port still lacks: the reference launcher's
    parameter sharding (`--production-mesh`, over `repro.dist.sharding`,
    which is not in the tree) raises.  The one-device step and its state
    exist; tests/test_torch_train.py holds them against the JAX package."""
    from repro_torch.launch import train
    cfg = get_smoke_config("gemma2-27b")
    assert callable(steps.make_train_step(cfg))
    assert set(steps.init_opt(cfg, {"w": torch.zeros(2)})) == {"adam"}
    with pytest.raises(ValueError, match="repro.dist.sharding"):
        train.main(["--arch", "gemma2-27b", "--smoke", "--production-mesh"], device="cpu")


@pytest.mark.parametrize("arch", ["gemma2-27b", "whisper-large-v3"])
def test_serve_main_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "24",
                      "--gen", "4"], device="cpu")
    assert out.shape == (2, 5) and out.dtype == torch.int64
    assert int(out.min()) >= 0 and int(out.max()) < get_smoke_config(arch).vocab
    printed = capsys.readouterr().out
    assert "prefill 2x24" in printed and "generated:" in printed


def test_serve_main_bfloat16_passes_steps_to_on_step(capsys):
    """`--dtype bfloat16` serves with bf16 parameters and caches, and
    `main`'s `on_step` sees the prefill and every decode step."""
    seen = []
    out = serve.main(["--arch", "gemma2-27b", "--smoke", "--batch", "2", "--prompt-len", "20",
                      "--gen", "3", "--dtype", "bfloat16"], device="cpu",
                     on_step=lambda stage, logits, c: seen.append((stage, logits, c)))
    assert [s for s, _, _ in seen] == ["prefill", "decode", "decode", "decode"]
    for i, (_, logits, _) in enumerate(seen):
        assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
        assert torch.equal(out[:, i], logits.argmax(dim=-1))
    caches = seen[-1][2]
    assert caches["units"][0]["k"].dtype == torch.bfloat16
    assert "generated:" in capsys.readouterr().out


def test_serve_generate_is_greedy_over_the_steps():
    """`generate` picks each token as the argmax of the step before it,
    and the decode steps see the tokens it picked."""
    cfg = get_smoke_config("qwen2-72b")
    params = lm.init_params(torch.Generator().manual_seed(4), cfg, torch.float32, "cpu")
    batch = serve.make_batch(cfg, 2, 12, seed=7, device="cpu")
    seen = []
    out, caches = serve.generate(params, cfg, batch, 3,
                                 on_step=lambda stage, logits, c: seen.append((stage, logits)))
    assert [s for s, _ in seen] == ["prefill", "decode", "decode", "decode"]
    for i, (_, logits) in enumerate(seen):
        assert torch.equal(out[:, i], logits.argmax(dim=-1))
    assert caches["units"][0]["k"].shape[2] == 12 + 3
