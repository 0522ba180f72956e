"""Gradient accumulation and rematerialisation in the port's training step,
on the CPU.

G: the port's Trainer(num_accumulation=2) takes one G step on a batch of 4
(two microbatches of 2) against the JAX package's
Trainer(num_accumulation=2).g_step on the same weights and batch, with the
adaptive VF weight on (one per microbatch), the draws off on both sides
(the JAX loss is called with rngs={}, the port with no generator) and
fp32. The rig is tests/test_torch_train.py's at 64 px cut to three
synthesis blocks without the additional ConvNeXt layers, and the
perceptual term is off: LPIPS's VGG and the fourth block were most of the
XLA compile, and test_torch_train.py holds both per microbatch. Both Adams
run with eps = 1: the update is then g / (|g| + 1), smooth in the gradient,
so the parameters after the step carry the summed gradient at
test_torch_train.py's gradient tolerance (with the default eps = 1e-8 and
beta1 = 0 the first update is lr * sign(g), which the two packages'
rounding can flip where g is near 0). Checked: the parameters, G's x_avg
(threaded through the microbatches), the EMA, the loss state, cur_nimg,
the merged stats and the returned total. The JAX step compiles once for
the module, with XLA's fast compile options, in a thread beside the port's
work.

D: the JAX D step with accumulation did not fit the files' time budget
beside G's, so the port's accumulated D gradients are held bit for bit
against the sum of two d_gradients calls on the two microbatches, from the
same spectral-norm buffers (test_torch_train.py holds d_gradients against
JAX through the D loss).

Remat: none, "full", "dots" and "names" give the same G loss terms and
gradients bit for bit, with the draws on; an unknown value raises.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_train import (
    ANCHOR,
    BUCKETS,
    FAST_COMPILE,
    LOSS_KW,
    RES,
    TINY_DINO,
    tiny_kwargs,
    write_siglip,
)
from tests.test_torch_generator import jax_variables_from_port, randomize_zero_init
from tests.torch_threads import one_torch_thread  # noqa: F401
from vfm_vae_tpu.models.discriminator import ProjectedDiscriminator as JaxD
from vfm_vae_tpu.models.generator import Generator as JaxG
from vfm_vae_tpu.models.generator import trainable_mask
from vfm_vae_tpu.models.generator import trainable_path_predicates as jax_predicates
from vfm_vae_tpu.train.loss import G_TRACKED as JAX_G_TRACKED
from vfm_vae_tpu.train.loss import TotalLoss as JaxTotalLoss
from vfm_vae_tpu.train.loss import init_loss_state as jax_init_loss_state
from vfm_vae_tpu.train.optim import Adam as JaxAdam
from vfm_vae_tpu.train.train_step import Trainer as JaxTrainer
from vfm_vae_tpu.train.train_step import TrainState as JaxTrainState
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.discriminator import ProjectedDiscriminator
from vfm_vae_tpu_torch.models.generator import (
    Generator,
    trainable_names,
    trainable_path_predicates,
)
from vfm_vae_tpu_torch.train.loss import G_TRACKED, TotalLoss
from vfm_vae_tpu_torch.train.lpips import LPIPS
from vfm_vae_tpu_torch.train.train_step import Trainer

BATCH, N_ACC = 4, 2
EQ = BUCKETS[0]  # the identity bucket: the adaptive VF weight's two pulls
OPT = dict(lr=1e-2, betas=(0.0, 0.99), eps=1.0)
# Past the EMA ramp's start, so that beta = 0.5 ** (4 / (44 * 0.05)) is not 0.
CUR_NIMG = 44
ACC_G = dict(num_blocks=3, add_additional_convnext=False)
ACC_LOSS = dict(LOSS_KW, perceptual_loss_weight=0.0, multiscale_block_indices=[0, 1],
                multiscale_pixel_loss_weights=[0.1, 0.1])
REMATS = ("none", "full", "dots", "names")


class NoDraws:
    """The JAX loss with its random draws off (rngs={}): the posterior mode,
    no DiffAugment, D resizing instead of cropping, as the port without a
    generator."""

    def __init__(self, loss):
        self._loss = loss

    def __getattr__(self, name):
        return getattr(self._loss, name)

    def g_terms(self, *args):
        return self._loss.g_terms(*args[:7], {}, *args[8:])


def port_trainer(kw, loss_kw, n_acc, g_sd=None, d_sd=None, opt=None):
    G = Generator(**kw)
    D = ProjectedDiscriminator(vfm_name="siglip2", dino_kwargs=TINY_DINO)
    L = LPIPS(generator=torch.Generator().manual_seed(0))
    for m, sd in ((G, g_sd), (D, d_sd)):
        if sd is not None:
            convert.load_state_dict_numpy(m, sd)
    loss = TotalLoss(G, D, vfm_name="siglip2", lpips_module=L, **loss_kw)
    return Trainer(loss, trainable_names(G, trainable_path_predicates("train_all")),
                   {n for n, _ in D.named_parameters() if not n.startswith("dino.")},
                   opt, opt, batch_size=BATCH, ema_kimg=1.0, num_accumulation=n_acc)


def port_side(root):
    """The D comparison and the remat runs (the port's work that runs while
    XLA compiles the JAX G step)."""
    kw = tiny_kwargs(write_siglip(root / "siglip2-tiny-patch8-64", RES))
    real = torch.from_numpy(np.random.default_rng(4).random((BATCH, RES, RES, 3))
                            .astype(np.float32))
    tr = port_trainer(kw, LOSS_KW, N_ACC)
    state = tr.init_state()
    buffers = {n: b.clone() for n, b in tr.D.named_buffers()}
    d = dict(acc=tr.d_accumulate(state, real, BUCKETS[1]))
    d["bufs"] = {n: b.clone() for n, b in tr.D.named_buffers()}
    with torch.no_grad():
        for n, b in tr.D.named_buffers():
            b.copy_(buffers[n])
    d["parts"] = [tr.d_gradients(state, chunk, BUCKETS[1]) for chunk in (real[:2], real[2:])]
    d["parts_bufs"] = {n: b.clone() for n, b in tr.D.named_buffers()}
    d["moved"] = any(not torch.equal(buffers[n], d["bufs"][n]) for n in buffers)

    remat = {}
    for policy in REMATS:
        tr = port_trainer(dict(kw, remat=policy), LOSS_KW, 1)
        state = tr.init_state()
        grads, terms, _, _, _ = tr.g_gradients(state, real[:2], BUCKETS[1],
                                               torch.Generator().manual_seed(3))
        tr.num_accumulation = 2
        acc, _, _, _ = tr.g_accumulate(state, real, BUCKETS[2], torch.Generator().manual_seed(5))
        remat[policy] = dict(G=tr.G, terms=terms, grads=grads, acc=acc)
    return d, remat


def host(stats) -> dict:
    return {k: np.asarray(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("acc")
    kw = dict(tiny_kwargs(write_siglip(root / "vfm" / "siglip2-tiny-patch8-64", RES)), **ACC_G)
    jg = JaxG(**kw)
    jd = JaxD(c_dim=0, vfm_name="siglip2", dino_kwargs=TINY_DINO)
    img = jnp.zeros((1, RES, RES, 3))
    key = jax.random.key(0, impl="unsafe_rbg")
    init = jax.jit(lambda r: jd.init({"params": r}, img, train=False))
    dv = jax.tree_util.tree_map(np.asarray, init.lower(key).compile(FAST_COMPILE)(key))
    gp, gb = jax_variables_from_port(kw)
    gp = randomize_zero_init(gp)
    dp, db = dv["params"], dv["buffers"]
    geometry = convert.geometry_from_kwargs(kw)
    g_sd = convert.state_dict_from_jax(gp, gb, geometry=geometry)

    jloss = JaxTotalLoss(jg, jd, vfm_name="siglip2", lpips_module=None,
                         **{k: v for k, v in ACC_LOSS.items() if k != "compression_mode"})
    g_mask = trainable_mask(gp, jax_predicates("train_all"))
    d_mask = jax.tree_util.tree_map(lambda _: False, dp)
    jt = JaxTrainer(NoDraws(jloss), JaxAdam(mask=g_mask, **OPT), JaxAdam(mask=d_mask, **OPT),
                    g_trainable_mask=g_mask, vf_anchor_path=ANCHOR, batch_size=BATCH,
                    ema_kimg=1.0, num_accumulation=N_ACC)
    def train_state(g_opt, d_opt, dp, db):
        return JaxTrainState(g_params=gp, d_params=dp, g_bufs=gb, d_bufs=db, ema_params=gp,
                             g_opt=g_opt, d_opt=d_opt, loss_state=jax_init_loss_state(),
                             cur_nimg=jnp.float32(CUR_NIMG))

    real = np.random.default_rng(9).random((BATCH, RES, RES, 3)).astype(np.float32)
    rng, real_j = jax.random.PRNGKey(0), jnp.asarray(real)
    # Lowered on the optimiser states' shapes and compiled in a thread (XLA
    # releases the GIL) while the port works; the states themselves come
    # from one jitted init (eager optax would compile an op per shape).
    lowered = jax.jit(jt.g_step, static_argnames=("eq", "blur_sigma")).lower(
        train_state(jax.eval_shape(jt.g_tx.init, gp), jax.eval_shape(jt.d_tx.init, dp), dp, db),
        real_j, None, rng, eq=EQ)
    compiled = {}
    thread = threading.Thread(target=lambda: compiled.setdefault(
        "g", lowered.compile(FAST_COMPILE)))
    thread.start()
    try:
        js = train_state(*jax.jit(lambda g, d: (jt.g_tx.init(g), jt.d_tx.init(d)))(gp, dp),
                         dp, db)
        tr = port_trainer(kw, ACC_LOSS, N_ACC, g_sd, convert.d_state_dict_from_jax(dp, db), OPT)
        before = {n: p.detach().clone() for n, p in tr.G.named_parameters()}
        state = tr.init_state(cur_nimg=CUR_NIMG)
        state, p_stats, p_total = tr.g_step(state, torch.from_numpy(real), EQ)
        d, remat = port_side(root)
    finally:
        thread.join()
    js, j_stats, j_total = compiled["g"](js, real_j, None, rng)
    g = dict(j_state=jax.tree_util.tree_map(np.asarray, js), j_stats=host(j_stats),
             j_total=float(j_total), p_stats={k: v.numpy() for k, v in p_stats.items()},
             p_total=float(p_total), before=before, state=state, trainer=tr,
             geometry=geometry)
    return dict(g=g, d=d, remat=remat, kw=kw)


def assert_update_close(name, got, want, before):
    """Parameters after the step: the update within 2e-3 of the JAX
    update's largest element (test_torch_train.py's gradient tolerance),
    plus the fp32 rounding of adding it to parameters of this size."""
    du, dw = got - before, want - before
    scale = float(np.abs(dw).max())
    assert scale > 0, f"{name}: the JAX step did not move it"
    atol = 2e-3 * scale + 4 * np.finfo(np.float32).eps * float(np.abs(before).max())
    np.testing.assert_allclose(du, dw, rtol=0, atol=atol, err_msg=name)


def test_accumulated_d_gradients_are_the_microbatches_sum(runs):
    d = runs["d"]
    grads, stats, total = d["acc"]
    (g0, t0, a0), (g1, t1, a1) = d["parts"]
    assert len(grads) > 10
    for a, b0, b1 in zip(grads, g0, g1):
        assert torch.equal(a, b0 + b1)
    assert any(float(g.abs().max()) > 0 for g in grads)
    assert float(total) == float((t0 + t1) / 2)
    want = {k: a0["stats"][k] + a1["stats"][k] for k in a0["stats"]}
    assert set(stats) == set(want)
    assert all(torch.equal(stats[k], want[k]) for k in want)
    # D's spectral-norm buffers advanced through both microbatches, in order.
    assert d["moved"]
    assert all(torch.equal(d["bufs"][n], d["parts_bufs"][n]) for n in d["bufs"])


def assert_stats_close(got: dict, want: dict, prefix: str):
    """Every merged stat of the phase: the counts exactly, the sums at the
    terms' tolerance. The tallies of logit signs are held by their counts
    only: a logit near 0 may take either sign in the two packages."""
    names = {k for k in want if k.startswith(prefix)}
    assert names and names <= set(got), sorted(names - set(got))
    for k in sorted(names):
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        assert g[0] == w[0], k
        if not k.endswith("_signs"):
            np.testing.assert_allclose(g[1:], w[1:], rtol=1e-3, atol=1e-5, err_msg=k)


def test_accumulated_g_step_matches_jax(runs):
    out = runs["g"]
    js, before, tr, state = out["j_state"], out["before"], out["trainer"], out["state"]
    jg = convert.state_dict_from_jax(js.g_params, js.g_bufs, geometry=out["geometry"])
    je = convert.state_dict_from_jax(js.ema_params, js.g_bufs, geometry=out["geometry"])
    trainable = sorted(tr.g_params)
    assert len(trainable) > 100
    for n in trainable:
        p = tr.g_params[n].detach().numpy()
        assert_update_close(n, p, jg[n].reshape(p.shape), before[n].numpy())
        # EMA: beta * old + (1 - beta) * new, with beta from the global batch.
        assert_update_close("ema " + n, state.ema[n].numpy(), je[n].reshape(p.shape),
                            before[n].numpy())
    x_avg = dict(tr.G.named_buffers())["mapping.x_avg"]  # advanced once per microbatch
    np.testing.assert_allclose(x_avg.numpy(), jg["mapping.x_avg"].reshape(x_avg.shape),
                               rtol=1e-4, atol=1e-6)
    assert state.cur_nimg == CUR_NIMG + BATCH == int(js.cur_nimg)
    # The loss state: the second microbatch's tracked terms.
    assert G_TRACKED == JAX_G_TRACKED
    np.testing.assert_allclose(state.loss_state.prev_g_loss.numpy(),
                               np.asarray(js.loss_state.prev_g_loss), rtol=1e-4, atol=1e-6)
    assert bool(state.loss_state.has_prev) == bool(js.loss_state.has_prev)
    np.testing.assert_allclose(out["p_total"], out["j_total"], rtol=1e-4, atol=1e-6)
    assert_stats_close(out["p_stats"], out["j_stats"], "Loss/G/")
    # The adaptive VF weight, one per microbatch.
    assert out["p_stats"]["Loss/G/cur_vf_loss_weight"][0] == N_ACC


# ------------------------------------------------------------------ remat


@pytest.mark.parametrize("remat", REMATS[1:])
def test_remat_policies_are_bit_identical(runs, remat):
    want, got = runs["remat"]["none"], runs["remat"][remat]
    assert got["G"].remat == remat and want["G"].remat is None
    assert all(torch.equal(a, b) for a, b in zip(got["terms"], want["terms"]))
    assert len(got["grads"]) > 100
    for a, b in zip(got["grads"] + got["acc"], want["grads"] + want["acc"]):
        assert torch.equal(a, b)
    assert any(float(g.abs().max()) > 0 for g in got["grads"])


def test_unknown_remat_raises(runs):
    kw = runs["kw"]
    with pytest.raises(ValueError, match="unknown remat policy"):
        Generator(**dict(kw, remat="everything"))
    assert Generator(**dict(kw, remat=True)).remat == "full"
    assert Generator(**dict(kw, remat=False)).remat is None
