"""The port's stage-0 training step (vfm_vae_tpu_torch.train) against the JAX
package on the CPU, at the tiny geometry of __graft_entry__._tiny_g_kwargs
with the VF, KL and adaptive-VF losses on, a tiny DINO (as
tests/test_train_step.py builds it) and LPIPS.

The image is 64 px, not the tiny 32: at 32 px the EQ-prior bucket 0.75 gives
a 3 px latent that the first z injector cannot unshuffle by 2, in both
packages alike. Weights cross from JAX through the port's converters; the
random draws are off on both sides (rngs={} in JAX, no generator in the
port): the posterior mode, no augmentation, D resizes instead of cropping.
Everything runs in fp32.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from __graft_entry__ import _tiny_g_kwargs
from tests.test_torch_generator import jax_variables_from_port, randomize_zero_init
from vfm_vae_tpu.core import stats as jax_stats
from vfm_vae_tpu.models.discriminator import ProjectedDiscriminator as JaxD
from vfm_vae_tpu.models.generator import Generator as JaxG
from vfm_vae_tpu.train.loss import G_TERMS as JAX_G_TERMS
from vfm_vae_tpu.train.loss import TotalLoss as JaxTotalLoss
from vfm_vae_tpu.train.lpips import LPIPS as JaxLPIPS
from vfm_vae_tpu.train.optim import ema_update as jax_ema_update
from vfm_vae_tpu_torch.core import stats
from vfm_vae_tpu_torch.entry import STAGE0_LOSS
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.discriminator import ProjectedDiscriminator
from vfm_vae_tpu_torch.models.generator import (
    Generator,
    trainable_names,
    trainable_path_predicates,
)
from vfm_vae_tpu_torch.train.loss import G_TERMS, TotalLoss
from vfm_vae_tpu_torch.train.lpips import LPIPS, build_lpips
from vfm_vae_tpu_torch.train.optim import adam, ema_beta, ema_update
from vfm_vae_tpu_torch.train.train_step import Trainer
from tests.torch_threads import one_torch_thread  # noqa: F401

RES = 64
TINY_DINO = dict(hidden_size=48, num_layers=2, num_heads=4, mlp_dim=96, patch_size=8,
                 image_size=32, hooks=(0, 1), hook_patch=True)
# Stage-0 loss weights; three multiscale images for the four tiny blocks.
LOSS_KW = dict(STAGE0_LOSS, multiscale_block_indices=[0, 1, 2],
               multiscale_pixel_loss_weights=[0.1, 0.1, 0.1])
BUCKETS = [(1.0, 0, False), (0.5, 1, False), (0.75, 0, True)]
ANCHOR = ("ldm_adapter", "final_quant", "blocks_0", "mlp", "w2", "weight")
# XLA:CPU compiles the tiny G + D + LPIPS graph with its backward passes in a
# fraction of the time without LLVM's expensive passes; the arithmetic is
# the same fp32.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def write_siglip(d, image_size: int) -> str:
    os.makedirs(d, exist_ok=True)
    cfg = dict(model_type="siglip_vision_model", hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128, image_size=image_size,
               patch_size=8, num_channels=3, layer_norm_eps=1e-6)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return str(d)


def tiny_kwargs(vfm_dir: str) -> dict:
    return dict(_tiny_g_kwargs(vfm_dir), img_resolution=RES, use_adaptive_vf_loss=True)


def port_modules(kw, g_sd=None, d_sd=None, l_sd=None):
    G = Generator(**kw)
    D = ProjectedDiscriminator(vfm_name="siglip2", dino_kwargs=TINY_DINO)
    L = LPIPS(generator=torch.Generator().manual_seed(0))
    for m, sd in ((G, g_sd), (D, d_sd), (L, l_sd)):
        if sd is not None:
            convert.load_state_dict_numpy(m, sd)
    loss = TotalLoss(G, D, vfm_name="siglip2", lpips_module=L, **LOSS_KW)
    trainer = Trainer(loss, trainable_names(G, trainable_path_predicates("train_all")),
                      {n for n, _ in D.named_parameters() if not n.startswith("dino.")},
                      batch_size=2, ema_kimg=1.0)
    return G, D, L, trainer


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    kw = tiny_kwargs(write_siglip(tmp_path_factory.mktemp("vfm") / "siglip2-tiny-patch8-64", RES))
    jg = JaxG(**kw)
    jd = JaxD(c_dim=0, vfm_name="siglip2", dino_kwargs=TINY_DINO)
    jl = JaxLPIPS()
    img = jnp.zeros((1, RES, RES, 3))

    def init(r):
        r2, r3 = jax.random.split(r)
        return (jd.init({"params": r2}, img, train=False),
                jl.init(r3, img[:, :32, :32], img[:, :32, :32])["params"])

    key = jax.random.key(0, impl="unsafe_rbg")
    dv, lp = jax.jit(init).lower(key).compile(FAST_COMPILE)(key)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    gp, gb = jax_variables_from_port(kw)
    gp = randomize_zero_init(gp)
    dp, db, lp = np_tree(dv["params"]), np_tree(dv["buffers"]), np_tree(lp)
    geometry = convert.geometry_from_kwargs(kw)
    g_sd = convert.state_dict_from_jax(gp, gb, geometry=geometry)
    d_sd = convert.d_state_dict_from_jax(dp, db)
    G, D, L, trainer = port_modules(kw, g_sd, d_sd, convert.lpips_state_dict_from_jax(lp))
    jloss = JaxTotalLoss(jg, jd, vfm_name="siglip2", lpips_module=jl,
                         **{k: v for k, v in LOSS_KW.items() if k != "compression_mode"})
    real = np.random.default_rng(0).random((2, RES, RES, 3)).astype(np.float32)
    return dict(kw=kw, gp=gp, gb=gb, dp=dp, db=db, lp=lp, geometry=geometry, jloss=jloss, d_sd=d_sd,
                G=G, D=D, trainer=trainer, real=real, cache={})


def jax_g_phase(rig, eq):
    """Terms and the gradient of every G parameter from one jax.vjp of
    g_terms with the draws off (train_step.py:221-244). For the identity
    bucket the VF weight is the adaptive one from the two anchor pulls; for
    the others it is the port's weight for the same bucket, so that one pull
    suffices (the XLA compile of each pull is most of this file's time)."""
    if eq in rig["cache"]:
        return rig["cache"][eq]
    loss = rig["jloss"]
    adaptive = eq == BUCKETS[0]

    @jax.jit
    def run(gp, real, w_given):
        def f(p):
            return loss.g_terms(p, rig["dp"], rig["gb"], rig["db"], rig["lp"], real, None, {},
                                eq, 0.0)[0]

        terms, vjp = jax.vjp(f, gp)

        def anchor(cot):
            leaf = vjp(tuple(cot[i] for i in range(len(JAX_G_TERMS))))[0]
            for k in ANCHOR:
                leaf = leaf[k]
            return leaf

        w_vf = w_given
        if adaptive:
            w_vf = jnp.linalg.norm(anchor(loss.rec_weights())) / (
                jnp.linalg.norm(anchor(loss.vf_cotangent())) + 1e-4)
            w_vf = jnp.clip(w_vf, 0.0, 1e8) * loss.vf_loss_weight
        weights = loss.g_weights(w_vf)
        grads = vjp(tuple(weights[i] for i in range(len(JAX_G_TERMS))))[0]
        return terms, w_vf, grads

    w_given = jnp.float32(0.0 if adaptive else port_g_phase(rig, eq)["w_vf"])
    args = (rig["gp"], jnp.asarray(rig["real"]), w_given)
    terms, w_vf, grads = run.lower(*args).compile(FAST_COMPILE)(*args)
    grads = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), rig["gb"],
                                        geometry=rig["geometry"])
    out = dict(terms=np.asarray(terms), w_vf=float(w_vf), grads=grads)
    rig["cache"][eq] = out
    return out


def port_g_phase(rig, eq):
    key = ("port", eq)
    if key not in rig["cache"]:
        tr = rig["trainer"]
        # Each D forward advances the spectral-norm power iteration; start
        # every bucket from the buffers JAX starts from.
        convert.load_state_dict_numpy(rig["D"], rig["d_sd"])
        state = tr.init_state()
        grads, terms, _, stats, _ = tr.g_gradients(state, torch.from_numpy(rig["real"]), eq,
                                                   update_buffers=False)
        rig["cache"][key] = dict(
            terms=np.array([float(t) for t in terms]),
            w_vf=float(stats["Loss/G/cur_vf_loss_weight"][1]),
            grads={n: g.numpy() for n, g in zip(tr.g_params, grads)})
    return rig["cache"][key]


def test_g_terms_order_matches_jax():
    assert G_TERMS == JAX_G_TERMS


@pytest.mark.parametrize("eq", BUCKETS, ids=["identity", "latent-0.5-rot1", "prior-0.75"])
def test_g_terms_match_jax(rig, eq):
    want, got = jax_g_phase(rig, eq), port_g_phase(rig, eq)
    on = [i for i, n in enumerate(G_TERMS) if want["terms"][i] != 0]
    assert {G_TERMS[i] for i in on} == {"l1_pixel_loss", "perceptual_loss",
                                         "multiscale_pixel_loss", "stylegan_t_gen_loss",
                                         "vf_loss", "kl_loss"}
    # fp32 on both sides, sums in another order; atol for the D logit mean,
    # a sum of signed terms that can cancel towards 0.
    np.testing.assert_allclose(got["terms"], want["terms"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("eq", BUCKETS, ids=["identity", "latent-0.5-rot1", "prior-0.75"])
def test_g_gradients_match_jax(rig, eq):
    want, got = jax_g_phase(rig, eq), port_g_phase(rig, eq)
    names = sorted(got["grads"])
    assert len(names) > 100 and not any(n.startswith("vfm_encoder.") for n in names)
    for n in names:
        w, g = want["grads"][n].reshape(got["grads"][n].shape), got["grads"][n]
        scale = float(np.abs(w).max())
        assert scale > 0, f"{n}: no gradient in the JAX step"
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * scale, err_msg=n)


def test_adaptive_vf_weight_matches_jax(rig):
    eq = BUCKETS[0]
    want, got = jax_g_phase(rig, eq), port_g_phase(rig, eq)
    assert want["w_vf"] > 0
    # The ratio of two gradient norms, each a sum over the anchor's elements.
    np.testing.assert_allclose(got["w_vf"], want["w_vf"], rtol=1e-3)


def test_adam_and_ema_match_optax():
    """One Adam update and one EMA update from identical gradients."""
    r = np.random.default_rng(3)
    p0 = {"a": r.standard_normal((4, 3)).astype(np.float32),
          "b": r.standard_normal((5,)).astype(np.float32)}
    grads = [{k: r.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(2)]
    tx = optax.adam(1e-4, b1=0.0, b2=0.99, eps=1e-8)
    jp, st = {k: jnp.asarray(v) for k, v in p0.items()}, None
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = adam(tp.values())
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        # Both apply lr * m / (sqrt(v_hat) + eps); the update is compared, not
        # two training runs.
        np.testing.assert_allclose(tp[k].detach().numpy() - p0[k], np.asarray(jp[k]) - p0[k],
                                   rtol=1e-5, atol=1e-10)
    beta = ema_beta(2, 1000, 1.0, 0.05)
    assert beta == 0.5 ** (2 / 50.0)
    ema = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ema_update(ema, {k: p.detach() for k, p in tp.items()}, beta)
    want = jax_ema_update({k: jnp.asarray(v) for k, v in p0.items()}, jp, beta)
    for k in p0:
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_stats_report_and_merge_match_jax():
    """[n, sum, sum of squares] per name, accumulated and merged."""
    r = np.random.default_rng(6)
    vals = [("a", r.standard_normal((3, 4))), ("b", r.standard_normal(())), ("a", r.random(5))]
    jt, pt = {}, {}
    for name, v in vals:
        jax_stats.report(jt, name, jnp.asarray(v, jnp.float32))
        stats.report(pt, name, torch.from_numpy(v.astype(np.float32)))
    jm, pm = jax_stats.merge(jt, {"b": jt["b"], "c": jt["a"]}), stats.merge(pt, {"b": pt["b"],
                                                                               "c": pt["a"]})
    assert set(pm) == set(jm) == {"a", "b", "c"}
    for k in jm:
        assert pm[k].shape == (3,) and pm[k].grad_fn is None
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=1e-6, atol=1e-6)


@pytest.fixture()
def port_rig(tmp_path):
    kw = tiny_kwargs(write_siglip(tmp_path / "siglip2-tiny-patch8-64", RES))
    G, D, L, trainer = port_modules(kw)
    with torch.no_grad():  # zero-initialised branches would leave their inputs without gradient
        for n, p in G.named_parameters():
            if n.endswith((".to_out.weight", ".ff.3.weight", ".null_kv", ".noise_strength")):
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.1)
    return G, D, L, trainer


def test_port_step_trains_what_it_should(port_rig):
    G, D, L, tr = port_rig
    before = {n: p.detach().clone() for m, pre in ((G, "G."), (D, "D."), (L, "L."))
              for n, p in ((pre + k, v) for k, v in m.named_parameters())}
    state = tr.init_state()
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    real = torch.from_numpy(np.random.default_rng(1).random((2, RES, RES, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    state, d_stats, d_total = tr.d_step(state, real, BUCKETS[1], gen)
    state, g_stats, g_total = tr.g_step(state, real, BUCKETS[1], gen)
    assert np.isfinite(float(d_total)) and np.isfinite(float(g_total))
    assert state.cur_nimg == 2
    after = {n: p.detach() for m, pre in ((G, "G."), (D, "D."), (L, "L."))
             for n, p in ((pre + k, v) for k, v in m.named_parameters())}
    trainable = {"G." + n for n in tr.g_params} | {"D." + n for n in tr.d_params}
    for n in before:
        changed = not torch.equal(before[n], after[n])
        assert changed == (n in trainable), n
    assert all(not torch.equal(ema0[k], state.ema[k]) for k in state.ema)
    assert set(state.ema) == set(tr.g_params)
    for key in ("Loss/D/stylegan_t/loss", "Loss/D/skipped", "Loss/D/is_safe/stylegan_t_gen_loss"):
        assert d_stats[key].shape == (3,), key
    for key in ("Loss/G/l1_pixel_loss", "Loss/G/vf_loss", "Loss/G/kl_loss", "Loss/G/skipped",
                "Loss/G/cur_vf_loss_weight", "Loss/G/is_safe/perceptual_loss",
                "Loss/G/multiscale_pixel_loss_block0", "Loss/G/stylegan_t/fake_scores"):
        assert g_stats[key].shape == (3,), key


def test_skip_gate_zeroes_gradients_and_still_steps_adam(port_rig):
    G, D, L, tr = port_rig
    state = tr.init_state(cur_nimg=100_000)  # past the safe-loss start
    state.loss_state.prev_g_loss.fill_(1e-5)  # every rec term is > 10x its previous value
    state.loss_state.has_prev.fill_(True)
    real = torch.from_numpy(np.random.default_rng(2).random((2, RES, RES, 3)).astype(np.float32))
    grads, _, new_ls, stats, _ = tr.g_gradients(state, real, BUCKETS[0])
    assert float(stats["Loss/G/skipped"][1]) == 1.0
    assert all(float(g.abs().max()) == 0.0 for g in grads)
    assert torch.equal(new_ls.prev_g_loss, state.loss_state.prev_g_loss)
    before = {n: p.detach().clone() for n, p in tr.g_params.items()}
    state, stats, _ = tr.g_step(state, real, BUCKETS[0])
    assert float(stats["Loss/G/skipped"][1]) == 1.0
    steps = {int(s["step"]) for s in state.g_opt.state.values()}
    assert steps == {1}  # Adam stepped every parameter, on zero gradients
    # beta1 = 0 and a zero first gradient: a zero update.
    assert all(torch.equal(before[n], p.detach()) for n, p in tr.g_params.items())


def test_unported_configurations_raise(port_rig):
    G, D, L, tr = port_rig
    with pytest.raises(NotImplementedError):
        TotalLoss(G, D, vfm_name="siglip2", lpips_module=L, **dict(LOSS_KW, clip_loss_weight=0.5))
    with pytest.raises(NotImplementedError):
        TotalLoss(G, D, vfm_name="siglip2", lpips_module=L,
                  **dict(LOSS_KW, matching_aware_loss_weight=0.5))
    # The warm-ups, the discrete mode and the D-input blur are ported
    # (tests/test_torch_warmup.py, tests/test_torch_discrete.py).
    warm = TotalLoss(G, D, vfm_name="siglip2", lpips_module=L,
                     **dict(LOSS_KW, use_stylegan_t_disc_warmup=True,
                            use_patchgan_disc_warmup=True))
    assert not warm.stylegan_t_on and not warm.patchgan_on
    # Accumulation is ported; a batch that num_accumulation does not divide
    # is refused, as the JAX package's assert B % n == 0 (train_step.py:72).
    acc = Trainer(tr.loss, set(tr.g_params), set(tr.d_params), num_accumulation=3)
    with pytest.raises(ValueError, match="not divisible into 3 microbatches"):
        acc.d_step(acc.init_state(), torch.zeros(2, RES, RES, 3), BUCKETS[0])
    with pytest.raises(ValueError, match="not divisible into 3 microbatches"):
        acc.g_step(acc.init_state(), torch.zeros(2, RES, RES, 3), BUCKETS[0])
    with pytest.raises(NotImplementedError):
        ProjectedDiscriminator(c_dim=10, dino_kwargs=TINY_DINO)
    with pytest.raises(NotImplementedError):
        trainable_path_predicates("train_text_encoder")
    with pytest.raises(ValueError):
        TotalLoss(G, D, vfm_name="siglip2", lpips_module=L,
                  **dict(LOSS_KW, compression_mode="binary"))
    with pytest.raises(RuntimeError):
        build_lpips("cpu")
