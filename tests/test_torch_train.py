"""Port parity for LM training, on the CPU: the loss and its gradients,
AdamW, gradient compression, the train step, checkpoints across the two
packages, and the train launcher.

Inputs are made with numpy from seeds and handed to both packages; the
JAX package's parameters go to the port with `params_from_numpy`.  Trees
are compared leaf by leaf in `jax.tree.leaves` order on both sides.
Everything runs in float32.  Tolerances, each stated where it is used:

- loss: 1e-5 absolute — a mean of logsumexps of order log V, summed in
  another order by each framework (float32 ulp at 5 is 5e-7);
- gradients: 1e-4 absolute, as the forward's logits in
  tests/test_torch_models.py: matmuls sum in other orders;
- train steps: parameters, moments and metrics within 1e-4 absolute and
  relative after three AdamW steps (the update divides by sqrt(v), so a
  gradient's few-ulp difference becomes a relative difference of the
  same size in its step).  Under gradient compression an element whose
  g / scale lies within that difference of an int8 bin edge rounds to
  neighbouring bins in the two packages, and its error, moments and
  parameter then differ by one bin's effect: those elements (1-2 a leaf
  in three steps here) are allowed, at most `max(3, n / 1000)` of a
  leaf's n, each within 5·lr;
- attention gradients: 1e-4 absolute on gradients of order 1 to 10:
  in the softcap cases scores reach tens, where float32's relative
  2^-24 in each exp leaves gradients a few 1e-5 apart.

The port runs with one torch thread here: its models are many small ops.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.runtime.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train import compression as jax_compression
from repro.train import optim as jax_optim
from repro.train import steps as jax_steps
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import layers, lm
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train import steps
from repro_torch.train.compression import compress_with_feedback, init_error
from repro_torch.train.optim import adamw_init, adamw_update

LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
STEP_TOL = 1e-4
ATTN_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    """A port tree (tensors) or a JAX tree as a tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _close_trees(got, exp, atol, rtol=0.0):
    g, e = jax.tree.leaves(_np(got)), jax.tree.leaves(_np(exp))
    assert len(g) == len(e)
    for a, b in zip(g, e):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def _close_but_bin_flips(got, exp, lr):
    """`_close_trees` at STEP_TOL but for a few elements a leaf (see the
    module docstring: int8 bin edges under compression)."""
    for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(_np(exp))):
        assert a.shape == b.shape
        off = ~np.isclose(a, b, atol=STEP_TOL, rtol=STEP_TOL)
        assert off.sum() <= max(3, a.size // 1000), (a.shape, int(off.sum()))
        np.testing.assert_allclose(a[off], b[off], atol=5 * lr)


def _batch(cfg, B, S, seed):
    """numpy tokens, labels and stubs as (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    np_in = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        np_in["patches"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        np_in["enc_embeds"] = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    jx = {k: jnp.asarray(v) for k, v in np_in.items()}
    pt = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
          for k, v in np_in.items()}
    return jx, pt


def _params(arch, seed):
    cfg = jax_get_smoke_config(arch)
    jp = jax_lm.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = lm.params_from_numpy(_np(jp), get_smoke_config(arch), "cpu")
    return cfg, jp, tp


def _port_value_and_grad(tp, cfg, b):
    live = lm.tree_map(lambda a: a.detach().requires_grad_(), tp)
    loss = lm.loss_fn(live, cfg, b["tokens"], b["labels"], enc_embeds=b.get("enc_embeds"),
                      patches=b.get("patches"))
    flat = iter(torch.autograd.grad(loss, lm.tree_leaves(live)))
    return loss, lm.tree_map(lambda _: next(flat), tp)


# ------------------------------------------------------------------ loss_fn
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg, jp, tp = _params(arch, seed=0)
    jx, pt = _batch(cfg, 2, 32, seed=1)

    def jloss(p):
        return jax_lm.loss_fn(p, cfg, jx["tokens"], jx["labels"],
                              enc_embeds=jx.get("enc_embeds"), patches=jx.get("patches"))

    exp_loss, exp_grads = jax.jit(jax.value_and_grad(jloss))(jp)
    loss, grads = _port_value_and_grad(tp, get_smoke_config(arch), pt)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(exp_loss), atol=LOSS_ATOL)
    _close_trees(grads, exp_grads, GRAD_ATOL)
    # every parameter takes part: no leaf's gradient is zero throughout
    assert all(np.any(g != 0) for g in jax.tree.leaves(_np(grads)))


# ------------------------------------------------------------ train steps
def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-27b"])
def test_three_train_steps_match_reference(arch, compress):
    """Three steps of `make_train_step` against the JAX package's jitted
    step on the same parameters and pipeline batches: metrics each step,
    then parameters and the whole optimizer state."""
    cfg, jp, tp = _params(arch, seed=3)
    tcfg = get_smoke_config(arch)
    jopt = jax_steps.init_opt(cfg, jp, compress_grads=compress)
    topt = steps.init_opt(tcfg, tp, compress_grads=compress)
    jstep = jax.jit(jax_steps.make_train_step(cfg, lr=1e-3, compress_grads=compress))
    tstep = steps.make_train_step(tcfg, lr=1e-3, compress_grads=compress)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, batch=2)
    for _ in range(3):
        b = pipe.next_batch()
        jp, jopt, jm = jstep(jp, jopt, _jax_batch(b))
        tp2, topt2, tm = tstep(tp, topt, _port_batch(b))
        assert tp2 is tp and topt2["adam"]["m"] is topt["adam"]["m"]   # updated in place
        tp, topt = tp2, topt2
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=STEP_TOL)
    assert int(topt["adam"]["step"]) == 3 and topt["adam"]["step"].dtype == torch.int32
    if compress:
        _close_but_bin_flips(tp, jp, 1e-3)
        _close_but_bin_flips(topt, jopt, 1e-3)
    else:
        _close_trees(tp, jp, STEP_TOL, STEP_TOL)
        _close_trees(topt, jopt, STEP_TOL, STEP_TOL)


# ------------------------------------------------------------------ AdamW
def _rand_tree(rng):
    return {"a": rng.standard_normal((8, 4)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32),
                  {"c": rng.standard_normal((3, 2, 2)).astype(np.float32)}]}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(5)
    p0 = _rand_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), _tensors(p0)
    jopt, topt = jax_optim.adamw_init(jp), adamw_init(tp)
    for _ in range(4):
        g = _rand_tree(rng)
        jp, jopt = jax_optim.adamw_update(jax.tree.map(jnp.asarray, g), jopt, jp,
                                          lr=1e-2, wd=0.1)
        tp, topt = adamw_update(_tensors(g), topt, tp, lr=1e-2, wd=0.1)
    _close_trees(tp, jp, 1e-6)
    _close_trees(topt, jopt, 1e-6)


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, opt = adamw_update(g, opt, params, lr=5e-2, wd=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_adamw_weight_decay_shrinks():
    params = {"w": torch.tensor([10.0])}
    opt = adamw_init(params)
    for _ in range(50):
        params, opt = adamw_update({"w": torch.zeros(1)}, opt, params, lr=1e-2, wd=0.5)
    assert float(params["w"][0]) < 10.0


# ------------------------------------------------------------ compression
def test_compress_with_feedback_matches_reference():
    """Five rounds of error feedback on random trees: the decompressed
    gradients and the carried error equal the JAX package's (one scale a
    leaf, the same int8 bins: no value lies near a bin edge here)."""
    rng = np.random.default_rng(6)
    g0 = _rand_tree(rng)
    jerr, terr = jax_compression.init_error(jax.tree.map(jnp.asarray, g0)), init_error(_tensors(g0))
    for _ in range(5):
        g = _rand_tree(rng)
        jdeq, jerr = jax_compression.compress_with_feedback(jax.tree.map(jnp.asarray, g), jerr)
        tdeq, terr = compress_with_feedback(_tensors(g), terr)
        _close_trees(tdeq, jdeq, 1e-6)
        _close_trees(terr, jerr, 1e-6)


@pytest.mark.parametrize("seed", range(5))
def test_compression_error_feedback_property(seed):
    """Quantize-with-feedback: per-step error is bounded by the int8 bin
    width, and the residual carries to the next step (EF contract)."""
    rng = np.random.default_rng(seed)
    g = {"w": torch.from_numpy(rng.normal(size=(32,)) * rng.uniform(0.1, 10))}
    err = init_error(g)
    deq, err2 = compress_with_feedback(g, err)
    scale = float(g["w"].abs().max()) / 127.0
    assert float((deq["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-9
    np.testing.assert_allclose(err2["w"].numpy(), (g["w"] - deq["w"]).numpy(),
                               rtol=1e-4, atol=1e-5)   # f32 arithmetic noise


def test_compression_accumulated_bias_vanishes():
    """Over repeated steps on a constant gradient, EF makes the *average*
    applied update converge to the true gradient."""
    g = {"w": torch.from_numpy(np.linspace(-1.0, 1.0, 16) * 0.01).float()}
    err = init_error(g)
    total = torch.zeros(16)
    steps_n = 50
    for _ in range(steps_n):
        deq, err = compress_with_feedback(g, err)
        total = total + deq["w"]
    np.testing.assert_allclose((total / steps_n).numpy(), g["w"].numpy(), atol=2e-4)


# ---------------------------------------------------- attention gradients
ATTN_CASES = {
    # (B, S, Sk, H, Hkv, D, causal, window, softcap, q scale)
    "gqa": (2, 64, 64, 4, 2, 16, True, 0, None, 1.0),
    "window_softcap": (1, 80, 80, 4, 2, 16, True, 16, 50.0, 12.0),
    "cross": (2, 24, 40, 4, 4, 16, False, 0, None, 1.0),
    "s4096_gqa": (1, 4096, 4096, 2, 1, 8, True, 0, None, 1.0),
    "s4096_window_softcap": (1, 4096, 4096, 2, 1, 8, True, 600, 5.0, 6.0),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_gradients_match_reference(case):
    """`layers.attn_scores` at q_start = k_start = 0 (the flash_attn
    Function: plain forward here, `grad.mha_backward`) against `jax.grad`
    of the JAX package's `attn_scores` (the jnp lowering, chunked and
    rematerialized above 2048 queries), for a random output cotangent."""
    B, S, Sk, H, Hkv, D, causal, window, softcap, qs = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q = (rng.standard_normal((B, S, H, D)) * qs).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    w = rng.standard_normal((B, S, H * D)).astype(np.float32)
    jcfg = dataclasses.replace(jax_get_smoke_config("gemma2-27b"), attn_softcap=softcap)
    tcfg = dataclasses.replace(get_smoke_config("gemma2-27b"), attn_softcap=softcap)

    def jf(q_, k_, v_):
        out = jax_layers.attn_scores(q_, k_, v_, jcfg, window=window, causal=causal)
        return jnp.sum(out * w)

    exp = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = layers.attn_scores(tq, tk, tv, tcfg, window=window, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for name, g, e in zip("qkv", got, exp):
        e = np.asarray(e)
        assert float(np.abs(e).max()) > 0.1, name
        np.testing.assert_allclose(g.numpy(), e, atol=ATTN_ATOL, err_msg=name)


def test_attention_saves_nothing_without_grad():
    """Serving calls (no input requires grad, or under no_grad) take the
    plain dispatch: the output has no grad_fn."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 8, 16)).astype(np.float32))
               for _ in range(3))
    cfg = get_smoke_config("starcoder2-3b")
    assert layers.attn_scores(q, k, v, cfg).grad_fn is None
    with torch.no_grad():
        assert layers.attn_scores(q.requires_grad_(), k, v, cfg).grad_fn is None
    assert layers.attn_scores(q, k, v, cfg).grad_fn is not None


# ------------------------------------------------------------ checkpoints
def test_jax_snapshot_restored_and_stepped_by_port(tmp_path):
    """The JAX package trains two steps and saves; the port restores that
    snapshot (parameters, AdamW state, pipeline cursor) and takes two more
    steps, equal to the JAX package's own continued run."""
    arch = "qwen2-72b"
    cfg = jax_get_smoke_config(arch)
    tcfg = get_smoke_config(arch)
    jp = jax_lm.init_params(jax.random.PRNGKey(7), cfg, jnp.float32)
    jopt = jax_steps.init_opt(cfg, jp)
    jstep = jax.jit(jax_steps.make_train_step(cfg, lr=1e-3))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, batch=2)
    for _ in range(2):
        jp, jopt, _ = jstep(jp, jopt, _jax_batch(pipe.next_batch()))
    JaxCheckpointManager(str(tmp_path), async_write=False).save(
        2, jp, jopt, extra={"pipeline": pipe.state_dict()})
    exp_losses = []
    for _ in range(2):
        jp, jopt, jm = jstep(jp, jopt, _jax_batch(pipe.next_batch()))
        exp_losses.append(float(jm["loss"]))

    like = lm.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    tp, topt, extra = CheckpointManager(str(tmp_path)).restore(
        2, like, steps.init_opt(tcfg, like), device="cpu")
    assert int(topt["adam"]["step"]) == 2
    tpipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, batch=2)
    tpipe.load_state_dict(extra["pipeline"])
    tstep = steps.make_train_step(tcfg, lr=1e-3)
    losses = []
    for _ in range(2):
        tp, topt, tm = tstep(tp, topt, _port_batch(tpipe.next_batch()))
        losses.append(float(tm["loss"]))
    np.testing.assert_allclose(losses, exp_losses, rtol=STEP_TOL)
    _close_trees(tp, jp, STEP_TOL, STEP_TOL)
    _close_trees(topt, jopt, STEP_TOL, STEP_TOL)


# --------------------------------------------------------------- launcher
def test_loss_decreases_on_structured_stream():
    losses = train_launch.main(["--arch", "starcoder2-3b", "--smoke", "--steps", "80",
                                "--batch", "8", "--seq", "32", "--lr", "3e-3",
                                "--log-every", "40"], device="cpu")
    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    assert last < first - 0.1, (first, last)


def test_checkpoint_resume_continuity(tmp_path):
    """Train 20 steps, checkpoint, resume for 10 more: the resumed loss
    sequence must equal an uninterrupted 30-step run's tail."""
    args = ["--arch", "qwen2-72b", "--smoke", "--batch", "4", "--seq", "16",
            "--lr", "1e-3", "--log-every", "100"]
    full = train_launch.main(args + ["--steps", "30"], device="cpu")
    d1 = str(tmp_path / "ck")
    train_launch.main(args + ["--steps", "20", "--ckpt-dir", d1, "--ckpt-every", "20"],
                      device="cpu")
    resumed = train_launch.main(args + ["--steps", "30", "--ckpt-dir", d1,
                                        "--ckpt-every", "100", "--resume"], device="cpu")
    np.testing.assert_allclose(resumed, full[20:], rtol=1e-4, atol=1e-5)


def test_production_mesh_raises():
    with pytest.raises(ValueError, match="repro.dist.sharding"):
        train_launch.main(["--arch", "starcoder2-3b", "--smoke", "--production-mesh"],
                          device="cpu")


def test_compressed_launcher_run_trains():
    losses = train_launch.main(["--arch", "starcoder2-3b", "--smoke", "--steps", "40",
                                "--batch", "8", "--seq", "32", "--lr", "3e-3",
                                "--compress-grads", "--log-every", "100"], device="cpu")
    assert np.all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5])
