"""The port's recipe modules against the JAX package on the CPU, on the same
inputs (numpy seeds) and the same weights (crossed through the port's
converters): config derivation, the loader's batches, the checkpoint
helpers, the loop's EQ draws, the trainable sets, SSIM, the PatchGAN
discriminator and its losses, and stage 2's and stage 3's G terms and D
loss at the tiny 64 px geometry of tests/test_torch_recipe.py.

Tolerances: exact equality where both sides compute the same integers or
draw from the same generators (configs, batches, draws, sets, helpers);
fp32 elsewhere, the sums in another order: SSIM 1e-6 absolute; PatchGAN
features 1e-5 of each map's scale; the losses 1e-6 relative; the stage
terms as tests/test_torch_train.py holds them (rtol 1e-4, atol 1e-6).
The random draws are off in the stage comparisons (rngs {} in JAX, no
generator in the port): the posterior mode, no augmentation, D resizes.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_data import make_shards
from tests.test_torch_generator import jax_variables_from_port, randomize_zero_init
from tests.test_torch_recipe import REPO, RES, TINY_DINO, stage_config, write_siglip
from vfm_vae_tpu.core import config as jax_config
from vfm_vae_tpu.data.wds import WdsWrapper as JaxWdsWrapper
from vfm_vae_tpu.models import discriminator as jax_disc
from vfm_vae_tpu.models.adapter import EquivarianceTransform as JaxEQ
from vfm_vae_tpu.models.generator import Generator as JaxG
from vfm_vae_tpu.models.generator import trainable_mask as jax_trainable_mask
from vfm_vae_tpu.models.generator import trainable_path_predicates as jax_predicates
from vfm_vae_tpu.train import checkpoint as jax_ckpt
from vfm_vae_tpu.train import loss as jax_loss
from vfm_vae_tpu.train.lpips import LPIPS as JaxLPIPS
from vfm_vae_tpu.train.ssim import ssim as jax_ssim
from vfm_vae_tpu_torch.core import config
from vfm_vae_tpu_torch.data.wds import WdsWrapper
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.discriminator import MultiscaleDiscriminator
from vfm_vae_tpu_torch.models.generator import Generator, trainable_names, trainable_path_predicates
from vfm_vae_tpu_torch.train import checkpoint, loss
from vfm_vae_tpu_torch.train.loop import build_trainer, make_eq_transform
from vfm_vae_tpu_torch.train.ssim import ssim

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
YAMLS = sorted(n for n in os.listdir(os.path.join(REPO, "configs")) if n.endswith(".yaml"))
MODES = ("train_all", "train_decoder", "train_the_second_half_decoder")


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def fast_jit(fn, *example):
    """fn compiled once for the examples' shapes, without XLA's expensive passes."""
    return jax.jit(fn).lower(*example).compile(FAST_COMPILE)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the tiny rig: its ops are too small to share,
    and under pytest-xdist's workers torch's default of a thread per core
    oversubscribes the host (the chain ran 10x slower beside six busy
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("recipe_parity")
    write_siglip(r / "siglip2-tiny-patch8-64")
    return r


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("name", YAMLS)
def test_derive_config_matches_jax(name):
    assert len(YAMLS) == 5
    path = os.path.join(REPO, "configs", name)
    want = jax_config.to_plain(jax_config.derive_config(jax_config.load_config(path)))
    got = config.to_plain(config.derive_config(config.load_config(path)))
    assert got == want


# ------------------------------------------------------------------ data


def test_loader_batches_match_jax(tmp_path):
    """The first two batches for a seed, bit for bit: one worker thread each
    (the order of several workers' samples depends on timing, in both
    packages), augmentation on, the default shuffle buffer."""
    make_shards(tmp_path, n_shards=2, per_shard=6, size=20)
    kw = dict(path=str(tmp_path), resolution=16, label_type="cls2text", data_augmentation=True)
    batches = []
    for cls in (JaxWdsWrapper, WdsWrapper):
        it = iter(cls(**kw).loader(batch_size=4, workers=0, base_seed=7))
        batches.append([next(it), next(it)])
        it.close()
    for (ji, jl), (pi, pl) in zip(*batches):
        assert pi.dtype == np.uint8 and pi.shape == (4, 16, 16, 3)
        np.testing.assert_array_equal(pi, ji)
        assert pl == jl


# ------------------------------------------------------------------ checkpoint


def test_checkpoint_helpers_match_jax(tmp_path):
    for kimg in (0, 41, 20000, 123456789):
        assert checkpoint.snapshot_name(kimg) == jax_ckpt.snapshot_name(kimg)
    assert checkpoint.find_latest_snapshot(str(tmp_path)) is None
    for name in ("network-snapshot-00000040", "network-snapshot-00001200",
                 "network-snapshot-00001200.tmp", "network-snapshot-00000999",
                 "network-snapshot-00005000.orbax-checkpoint-tmp", "other-00009000"):
        os.makedirs(tmp_path / name)
    assert checkpoint.find_latest_snapshot(str(tmp_path)) == \
        jax_ckpt.find_latest_snapshot(str(tmp_path)) == \
        (str(tmp_path / "network-snapshot-00001200"), 1200)

    r = np.random.default_rng(0)
    template = {"a": {"w": np.zeros((3, 4)), "b": np.zeros(4), "empty": {}},
                "opt": {"mu": {"x": np.zeros(2), "gone": np.zeros(5)}, "count": np.zeros(())},
                "n": 0}
    loaded = {"a": {"w": r.random((3, 4)), "b": r.random(5), "extra": r.random(2)},
              "opt": {"mu": {"x": r.random(2)}, "count": np.float32(7.0)},
              "n": 12, "stray": r.random(3)}
    got = checkpoint.merge_loaded(template, loaded)
    want = jax_ckpt.merge_loaded(template, loaded)
    assert checkpoint.flat_keys(got).keys() == checkpoint.flat_keys(want).keys()
    for k, v in checkpoint.flat_keys(want).items():
        assert checkpoint.flat_keys(got)[k] is v, k
    assert got["a"]["w"] is loaded["a"]["w"] and got["a"]["b"] is template["a"]["b"]
    assert got["a"]["empty"] == {}


# ------------------------------------------------------------------ EQ draws


@pytest.mark.parametrize("stage", [0, 3])
def test_eq_draws_match_jax(root, stage):
    c = stage_config(root, stage)
    eq = make_eq_transform(c.G_kwargs, c.loss_kwargs)
    want_eq = JaxEQ(apply=bool(c.loss_kwargs.use_equivariance_regularization),
                    p_eq_prior=c.G_kwargs.equivariance_regularization_p_prior,
                    p_eq_prior_scale=c.G_kwargs.equivariance_regularization_p_prior_scale)
    r1, r2 = np.random.default_rng(42), np.random.default_rng(42)
    got = [eq(r1) for _ in range(64)]
    assert got == [want_eq(r2) for _ in range(64)]
    assert len(set(got)) > (8 if stage == 0 else 0)


# ------------------------------------------------------------------ trainable sets


@pytest.fixture(scope="module")
def tiny_g(root):
    kw = {k: v for k, v in stage_config(root, 0).G_kwargs.items() if k != "class_name"}
    gp, gb = jax_variables_from_port(kw)
    return kw, gp, gb, Generator(**kw)


@pytest.mark.parametrize("mode", MODES)
def test_trainable_sets_match_jax(tiny_g, mode):
    """JAX's trainable_mask, carried onto the port's names by the weight
    converter (each leaf replaced by its mask value), equals the port's set."""
    kw, gp, gb, G = tiny_g
    res = G.synthesis.block_resolutions
    mask = jax_trainable_mask(gp, jax_predicates(
        mode, block_resolutions=res, concat_z_block_indices=kw["concat_z_block_indices"]))
    marked = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                                    gp, mask)
    sd = convert.state_dict_from_jax(marked, gb, geometry=convert.geometry_from_kwargs(kw))
    params = {n for n, _ in G.named_parameters()}
    mixed = [n for n in params if not np.all(sd[n] == sd[n].flat[0])]
    assert not mixed
    want = {n for n in params if sd[n].flat[0] == 1.0}
    got = trainable_names(G, trainable_path_predicates(
        mode, block_resolutions=res, concat_z_block_indices=G.synthesis.concat_z))
    assert got == want and got
    if mode == "train_the_second_half_decoder":
        assert {n.split(".")[2] for n in got} == {"3"}


# ------------------------------------------------------------------ SSIM, PatchGAN


def test_ssim_matches_jax():
    r = np.random.default_rng(1)
    x = r.uniform(-1, 1, (2, 40, 36, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * r.standard_normal(x.shape), -1, 1).astype(np.float32)
    jssim = fast_jit(lambda a, b: jax_ssim(a, b, data_range=2.0), x, y)
    for a, b in ((x, y), (x, x), (y, -y)):
        want = float(jssim(jnp.asarray(a), jnp.asarray(b)))
        got = float(ssim(torch.from_numpy(a), torch.from_numpy(b), data_range=2.0))
        assert abs(got - want) <= 1e-6, (got, want)


@pytest.fixture(scope="module")
def patchgan_pair(stage_weights):
    """The JAX MultiscaleDiscriminator with the stage rig's PatchGAN weights."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    jm = jax_disc.MultiscaleDiscriminator(get_interm_feat=True)
    params = stage_weights["dp"]["patchgan"]
    want = fast_jit(lambda p, x: jm.apply({"params": p}, x), params, x)(params, x)
    pm = MultiscaleDiscriminator(get_interm_feat=True)
    convert.load_state_dict_numpy(pm, convert.patchgan_state_dict_from_jax(params))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    return np_tree(want), [[f.numpy() for f in r] for r in got]


def test_patchgan_features_match_jax(patchgan_pair):
    want, got = patchgan_pair
    assert [len(r) for r in got] == [len(r) for r in want] == [5, 5, 5]
    for i, (wr, gr) in enumerate(zip(want, got)):
        for j, (w, g) in enumerate(zip(wr, gr)):
            assert g.shape == w.shape, (i, j)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"scale {i} layer {j}")


@pytest.mark.parametrize("loss_type", ["mse", "bce", "hinge"])
def test_patchgan_losses_match_jax(loss_type):
    r = np.random.default_rng(4)
    preds = [r.standard_normal((2, s, s, 1)).astype(np.float32) for s in (11, 7, 5)]
    tp = [torch.from_numpy(p) for p in preds]
    want = fast_jit(lambda p: [jax_loss.patchgan_d_loss(p, "real", loss_type),
                               jax_loss.patchgan_d_loss(p, "fake", loss_type),
                               jax_loss.patchgan_g_loss(p, loss_type)], preds)(preds)
    got = [loss.patchgan_d_loss(tp, "real", loss_type), loss.patchgan_d_loss(tp, "fake", loss_type),
           loss.patchgan_g_loss(tp, loss_type)]
    for got, want in zip(got, want):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_feature_matching_loss_matches_jax(patchgan_pair):
    want, _ = patchgan_pair
    r = np.random.default_rng(5)
    fake = [[f + 0.1 * r.standard_normal(f.shape).astype(np.float32) for f in s] for s in want]
    got = loss.feature_matching_loss([[torch.from_numpy(f) for f in s] for s in want],
                                     [[torch.from_numpy(f) for f in s] for s in fake])
    ref = fast_jit(jax_loss.feature_matching_loss, want, fake)(want, fake)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# ------------------------------------------------------------------ stages 2, 3


STAGE_EQ = {2: (0.5, 1, False), 3: (1.0, 0, False)}


def filled(shapes, seed: int):
    """Values for a JAX variable tree of ShapeDtypeStructs, from a numpy
    generator, without compiling an init: fan-in-scaled normals for every
    matrix and kernel, 1 + noise for vector scales, small vectors and
    embeddings otherwise, unit vectors for the spectral-norm states."""
    r = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(path[-1].key)
        if name in ("u", "v"):
            x = r.standard_normal(v.shape)
            return (x / np.linalg.norm(x)).astype(np.float32)
        if v.ndim >= 2 and name not in ("cls_token", "pos_embed"):
            return (r.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        if v.ndim == 1 and name in ("weight", "scale"):
            return (1 + 0.1 * r.standard_normal(v.shape)).astype(np.float32)
        return (0.02 * r.standard_normal(v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def stage_weights(root):
    """JAX D (with the PatchGAN branch; stage 2 takes it without) and LPIPS
    parameters filled in numpy on the init's shapes (jax.eval_shape: no
    compile), and G's from a port G."""
    c = stage_config(root, 3)
    gk = {k: v for k, v in c.G_kwargs.items() if k != "class_name"}
    jd = jax_disc.ProjectedDiscriminator(c_dim=0, vfm_name=gk["vfm_name"], dino_kwargs=TINY_DINO,
                                         use_patchgan_discriminator=True, get_interm_feat=True)
    jl = JaxLPIPS()
    img = jnp.zeros((1, RES, RES, 3))

    def init(r):
        r2, r3 = jax.random.split(r)
        return (jd.init({"params": r2}, img, train=False),
                jl.init(r3, img[:, :32, :32], img[:, :32, :32])["params"])

    dv, lp = filled(jax.eval_shape(init, jax.random.key(7)), 7)
    gp, gb = jax_variables_from_port(gk)
    return dict(dp=np_tree(dv["params"]), db=np_tree(dv["buffers"]), lp=np_tree(lp),
                gp=randomize_zero_init(gp), gb=gb)


@pytest.fixture(scope="module", params=[2, 3], ids=["stage2", "stage3"])
def stage_pair(request, root, stage_weights):
    """One forward-only XLA program per stage: the JAX G terms and D loss;
    the port's from the trainer its loop builds, on the same weights."""
    stage = request.param
    c = stage_config(root, stage)
    gk = {k: v for k, v in c.G_kwargs.items() if k != "class_name"}
    lk = {k: v for k, v in c.loss_kwargs.items() if k not in ("class_name", "vfm_name")}
    pg = bool(c.D_kwargs.use_patchgan_discriminator)
    jg = JaxG(**gk)
    jd = jax_disc.ProjectedDiscriminator(c_dim=0, vfm_name=gk["vfm_name"], dino_kwargs=TINY_DINO,
                                         use_patchgan_discriminator=pg,
                                         get_interm_feat=c.D_kwargs.get_interm_feat)
    jl = JaxLPIPS() if lk["perceptual_loss_weight"] > 0 else None
    w = stage_weights
    dp = {k: v for k, v in w["dp"].items() if pg or k != "patchgan"}
    db, gp, gb, lp = w["db"], w["gp"], w["gb"], w["lp"] if jl else {}
    real = np.random.default_rng(stage).random((2, RES, RES, 3)).astype(np.float32)
    eq = STAGE_EQ[stage]
    jloss = jax_loss.TotalLoss(jg, jd, vfm_name=gk["vfm_name"], lpips_module=jl, **lk)

    def run(gp, dp, real):
        terms, _ = jloss.g_terms(gp, dp, gb, db, lp, real, None, {}, eq, 0.0)
        d_total, aux = jloss.d_loss(dp, gp, gb, db, real, None, {}, eq, 0.0)
        return jnp.stack(terms), d_total, aux["stats"]

    args = (gp, dp, jnp.asarray(real))
    terms, d_total, d_stats = jax.jit(run).lower(*args).compile(FAST_COMPILE)(*args)

    tr = build_trainer(c.G_kwargs, c.D_kwargs, c.loss_kwargs, c.G_opt_kwargs, c.D_opt_kwargs,
                       device="cpu", compute_dtype="float32", allow_random_lpips=True)
    d_sd = convert.d_state_dict_from_jax(dp, db)
    convert.load_jax_variables(tr.G, gp, gb, geometry=convert.geometry_from_kwargs(gk))
    convert.load_state_dict_numpy(tr.D, d_sd)
    if jl:
        convert.load_state_dict_numpy(tr.loss.lpips, convert.lpips_state_dict_from_jax(lp))
    real_t = torch.from_numpy(real)
    with torch.no_grad():
        p_terms, _ = tr.loss.g_terms(real_t, eq, 0.0)
        convert.load_state_dict_numpy(tr.D, d_sd)  # D's spectral-norm state as JAX starts it
        p_total, p_aux = tr.loss.d_loss(real_t, eq, 0.0)
    return dict(stage=stage, want=(np.asarray(terms), float(d_total), np_tree(d_stats)),
                got=(np.array([float(t) for t in p_terms]), float(p_total), p_aux["stats"]))


def test_stage_g_terms_match_jax(stage_pair):
    (want, _, _), (got, _, _) = stage_pair["want"], stage_pair["got"]
    on = {loss.G_TERMS[i] for i in np.flatnonzero(want)}
    if stage_pair["stage"] == 2:
        assert {"ssim_loss", "perceptual_loss", "l1_pixel_loss",
                "multiscale_pixel_loss", "stylegan_t_gen_loss"} <= on
        assert "vf_loss" not in on
    else:
        assert on >= {"stylegan_t_gen_loss", "patchgan_gen_loss", "feature_matching_loss"}
        assert not on & {"ssim_loss", "perceptual_loss", "l1_pixel_loss", "vf_loss"}
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_stage_d_loss_matches_jax(stage_pair):
    (_, want, wstats), (_, got, gstats) = stage_pair["want"], stage_pair["got"]
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert set(gstats) == set(wstats)
    for k in ("Loss/D/stylegan_t/loss", "Loss/D/patchgan/loss"):
        if k in wstats:
            np.testing.assert_allclose(gstats[k].numpy(), wstats[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert ("Loss/D/patchgan/loss" in wstats) == (stage_pair["stage"] == 3)
