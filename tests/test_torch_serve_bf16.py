"""Port parity for bfloat16 serving, on the CPU.

For each of the ten architectures at smoke size: the JAX package's
bfloat16 parameters (`init_params(PRNGKey(0), cfg, jnp.bfloat16)`) go to
the port as float32 numpy (`params_from_numpy`) and are cast back to
bfloat16 here, exactly, and the port's logits are held against
the JAX package's at the prefill (B 2, S 16) and at three teacher-forced
decode steps, with numpy-made tokens and bfloat16 frontend stubs.  The
JAX package's steps are jitted, as its `launch/serve.py` runs them.  Each
side carries its own caches, and their leaves keep the reference's
dtypes: the SSM state a decode step leaves is float32 in both.

Tolerance: max |port - reference| <= 0.04 * max |reference logit| at
every step.  The two frameworks round bfloat16 matmuls and their float32
accumulations differently.  Over these inputs the gaps measured were
0.0063-0.0304, the largest recurrentgemma-9b's at its second decode
step (`pytest -s` prints each architecture's four).  The file takes
≈ 75 s alone, on one torch thread, most of it the JAX package's
compiles.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import lm as jax_lm
from repro.train import steps as jax_steps
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.train import steps

B, S, N_DEC = 2, 16, 3
REL_TOL = 0.04


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(cfg, seed):
    """numpy tokens and stubs (the stubs as bfloat16 on both sides)."""
    rng = np.random.default_rng(seed)
    np_in = {"tokens": rng.integers(0, cfg.vocab, (B, S + N_DEC)).astype(np.int32)}
    if cfg.frontend == "vision":
        np_in["patches"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        np_in["enc_embeds"] = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    jx = {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, jnp.bfloat16)
          for k, v in np_in.items()}
    pt = {k: torch.from_numpy(v.astype(np.int64)) if k == "tokens"
          else torch.from_numpy(v).to(torch.bfloat16) for k, v in np_in.items()}
    return jx, pt


def _gap(got, exp) -> float:
    """max |got - exp| / max |exp|, both read as float32."""
    exp = np.asarray(exp.astype(jnp.float32))
    return float(np.abs(got.float().numpy() - exp).max() / np.abs(exp).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch):
    cfg = jax_get_smoke_config(arch)
    tcfg = get_smoke_config(arch)
    jp = jax.jit(functools.partial(jax_lm.init_params, cfg=cfg, dtype=jnp.bfloat16))(
        jax.random.PRNGKey(0))
    tp = lm.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
        lm.params_from_numpy(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp),
                             tcfg, "cpu"))
    jx, pt = _inputs(cfg, seed=11)
    extra = [k for k in ("patches", "enc_embeds") if k in jx]
    exp, jc = jax.jit(jax_steps.make_prefill_step(cfg))(
        jp, {"tokens": jx["tokens"][:, :S], **{k: jx[k] for k in extra}})
    got, tc = steps.make_prefill_step(tcfg)(
        tp, {"tokens": pt["tokens"][:, :S], **{k: pt[k] for k in extra}})
    gaps = [_gap(got, exp)]
    dtypes = [(str(got.dtype), str(exp.dtype))]
    jdec = jax.jit(jax_steps.make_decode_step(cfg), static_argnames=("pos",))
    tdec = steps.make_decode_step(tcfg)
    for i in range(N_DEC):
        jb = {"tokens": jx["tokens"][:, S + i:S + i + 1]}
        tb = {"tokens": pt["tokens"][:, S + i:S + i + 1]}
        if cfg.is_enc_dec:
            jb["enc_embeds"], tb["enc_embeds"] = jx["enc_embeds"], pt["enc_embeds"]
        exp, jc = jdec(jp, jc, jb, pos=S + i)
        got, tc = tdec(tp, tc, tb, pos=S + i)
        gaps.append(_gap(got, exp))
        dtypes.append((str(got.dtype), str(exp.dtype)))
    print(f"{arch}: gaps {' '.join(f'{g:.4f}' for g in gaps)}")
    assert dtypes == [("torch.bfloat16", "bfloat16")] * (1 + N_DEC)
    assert max(gaps) <= REL_TOL, gaps
    # the caches the port carried hold the reference's dtypes, leaf by leaf
    got_dtypes = jax.tree.leaves(lm.tree_map(lambda t: str(t.dtype).removeprefix("torch."), tc))
    assert got_dtypes == [str(np.dtype(a.dtype)) for a in jax.tree.leaves(jc)]


def test_serve_main_decodes_mamba2_in_bfloat16():
    """`serve.main` on mamba2 in bf16 runs its decode steps: the SSM's
    decode einsum takes its float32 state with the bf16 C projection, as
    the reference's promoting einsum does, and the state stays float32."""
    seen = []
    out = serve.main(["--arch", "mamba2-1.3b", "--smoke", "--batch", "2", "--prompt-len", "16",
                      "--gen", "3", "--dtype", "bfloat16"], device="cpu",
                     on_step=lambda stage, logits, c: seen.append((stage, logits, c)))
    assert [s for s, _, _ in seen] == ["prefill", "decode", "decode", "decode"]
    for i, (_, logits, _) in enumerate(seen):
        assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
        assert torch.equal(out[:, i], logits.argmax(dim=-1))
    ssm = seen[-1][2]["units"][0]
    assert ssm["state"].dtype == torch.float32 and ssm["conv"].dtype == torch.bfloat16
