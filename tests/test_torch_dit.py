"""The port's latent-diffusion stack against the JAX package on the CPU, on
the same inputs (numpy seeds) and the same weights (JAX's, crossed through
models/convert.dit_state_dict_from_jax): the DiT at a tiny size with the
LightningDiT flags and with the REG flags (conditional and null class,
the feature tap and the per-block features), the flow-matching loss and
every parameter's gradient given JAX's draws, one AdamW + EMA step against
optax, the Euler ODE and SDE samplers given JAX's noise, the trainers'
batch streams (the JAX tools' functions, imported by path), CKNNA in its
three modes and the alignment preprocessing records.

Tolerances, fp32 on both sides with sums in another order: outputs and
features 2e-5 of each tensor's largest magnitude; the loss 1e-5 relative;
gradients 1e-4 of each gradient's largest magnitude; parameters and EMA
after two AdamW steps on the same gradients 1e-6 relative; samples 1e-4 of
their largest magnitude; CKNNA 1e-5 absolute; batches, records and noised
images exactly. adaLN, final_adaLN and final_linear start at zero, so every
parameter is drawn with numpy (on the shapes of the JAX init) and every
branch is live. Each group of cases goes through one XLA compile.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from tests.test_torch_metrics import FAST_COMPILE, load_script
from vfm_vae_tpu.metrics import cknna as jax_cknna
from vfm_vae_tpu.models.dit import LightningDiT as JaxDiT
from vfm_vae_tpu.train import transport as jax_transport
from vfm_vae_tpu_torch.data.safetensors_io import save_file
from vfm_vae_tpu_torch.metrics import cknna
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.dit import LightningDiT, REPAProjector, swiglu_hidden
from vfm_vae_tpu_torch.ops.attention import flash_eligible_shape
from vfm_vae_tpu_torch.tools import alignment_preprocess, lightningdit_train, reg_train
from vfm_vae_tpu_torch.tools._dit import DiTTrainer
from vfm_vae_tpu_torch.train import transport

GRID, CH, NCLS, B = 4, 8, 10, 4
TINY = dict(input_size=GRID, in_channels=CH, hidden_size=64, depth=2, num_heads=4,
            num_classes=NCLS)
FLAGS = {  # the LightningDiT YAMLs' flags, and the REG SiT's
    "lightningdit": dict(use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True),
    "reg": dict(use_qknorm=True, use_swiglu=False, use_rope=False, use_rmsnorm=False),
}
DROP = np.array([True, False, True, False])
REPA_DIM, REPA_BLOCK = 12, 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err:.3e} > {rel} x {scale:.3e}"


def run_fast(fn, *args):
    """fn(*args) through one XLA compile without the expensive passes."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def draw_params(init, seed):
    """Parameters of the tree `init(key)` would make (traced, not run),
    drawn with numpy: Linear kernels (in, out) uniform within 1/sqrt(in),
    norm weights 1 + N(0, 0.1), biases and tables N(0, 0.05), the
    zero-initialised Linears included."""
    r = np.random.default_rng(seed)

    def draw(path, leaf):
        shape, name = leaf.shape, path[-1].key
        if name == "weight" and len(shape) == 2:
            v = r.uniform(-1, 1, shape) / np.sqrt(shape[0])
        elif name == "weight":
            v = 1 + r.normal(0, 0.1, shape)
        else:
            v = r.normal(0, 0.05, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init, jax.random.PRNGKey(0)))


def init_params(jm, seed):
    x, t, y = inputs()
    return draw_params(lambda k: jm.init(k, x, t, y)["params"], seed)


def to_port(params, **kw):
    m = LightningDiT(**TINY, **kw)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in
                       convert.dit_state_dict_from_jax(params).items()}, strict=True)
    return m.eval()


def inputs(seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, GRID, GRID, CH)).astype(np.float32)
    t = r.uniform(0.05, 0.95, (B,)).astype(np.float32)
    y = r.integers(0, NCLS, (B,)).astype(np.int32)
    return x, t, y


@pytest.fixture(scope="module", params=sorted(FLAGS))
def models(request):
    """(flags name, JAX module, randomised params, port module), with the REPA tap."""
    kw = dict(FLAGS[request.param], return_features_at=REPA_BLOCK)
    jm = JaxDiT(**TINY, **kw)
    params = init_params(jm, 2)
    x, t, y = inputs(1)
    drop = jnp.asarray(DROP)

    def outputs(p, y):
        h, feats = jm.apply({"params": p}, x, t, y, collect_block_features=True)
        tap = jm.apply({"params": p}, x, t, y)[1]
        forced = jm.apply({"params": p}, x, t, y, force_drop_ids=drop)[0] if y is not None else h
        return h, feats, tap, forced

    want = run_fast(lambda p: {"class": outputs(p, y), "null": outputs(p, None)}, params)
    return request.param, want, to_port(params, **kw)


@pytest.mark.parametrize("cond", ["class", "null"])
def test_dit_forward_matches_jax(models, cond):
    name, want, pm = models
    x, t, y = inputs(1)
    jh, jfeats, jtap, _ = want[cond]
    with torch.no_grad():
        yt = torch.from_numpy(y).long() if cond == "class" else None
        ph, pfeats = pm(torch.from_numpy(x), torch.from_numpy(t), yt, collect_block_features=True)
        ptap = pm(torch.from_numpy(x), torch.from_numpy(t), yt)[1]
    close(ph, jh, 2e-5, f"{name} output")
    close(ptap, jtap, 2e-5, f"{name} tap")
    assert set(pfeats) == set(jfeats) == {"embedder", "block_0", "block_1", "final_layer",
                                          "repa_tokens"}
    for k in jfeats:
        close(pfeats[k], jfeats[k], 2e-5, f"{name} {k}")
    assert (pm.pos_embed is None) == FLAGS[name]["use_rope"]


def test_force_drop_ids_select_the_null_class(models):
    _, want, pm = models
    x, t, y = inputs(1)
    drop = DROP
    jh = want["class"][3]
    with torch.no_grad():
        ph = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long(),
                force_drop_ids=torch.from_numpy(drop))[0]
        pd = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long(),
                drop=torch.from_numpy(drop))[0]
    close(ph, jh, 2e-5, "force_drop_ids")
    assert torch.equal(ph, pd)


def test_xl_geometry():
    """XL's SwiGLU width and head dim: 3072 and 72, so its attention stays on
    SDPA with or without the flash opt-in, as the JAX rule says."""
    assert swiglu_hidden(1152, 4.0) == 3072
    assert not flash_eligible_shape(256, 256, 1152 // 16, False, prefer=True)
    assert flash_eligible_shape(256, 256, 768 // 12, False, prefer=True)  # B/1: d 64


def jax_draws(rng, shape, use_lognorm, p_drop=0.1):
    """The draws inside JAX's flow_matching_loss and the model's class
    dropout (traced with the loss, so they share its compile)."""
    r_t, r_noise, r_drop = jax.random.split(rng, 3)
    t = jax.random.normal(r_t, (shape[0],)) if use_lognorm else jax.random.uniform(r_t, (shape[0],))
    noise = jax.random.normal(r_noise, shape)
    drop = jax.random.bernoulli(r_drop, p_drop, (shape[0],))
    return t, noise, drop


def to_torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def port_grads(module):
    return {n: p.grad.numpy() for n, p in module.named_parameters()}


FM_CASES = {"lognorm-cosine": (True, True), "uniform-cosine": (False, True),
            "lognorm-mse": (True, False)}
FM_RNG = 6


@pytest.fixture(scope="module")
def fm_want(ldit):
    """JAX's (loss, aux), gradients and draws in each FM_CASES case, one
    compile."""
    jm, params, _ = ldit
    x, _, y = inputs(3)
    rng = jax.random.PRNGKey(FM_RNG)

    def model_fn(p, xt, tt, yy, r):
        return jm.apply({"params": p}, xt, tt, yy, train=r is not None, rng=r)

    def case(p, lognorm, cosine):
        return jax.value_and_grad(lambda q: jax_transport.flow_matching_loss(
            model_fn, q, x, y, rng, use_lognorm=lognorm, use_cosine_loss=cosine),
            has_aux=True)(p) + (jax_draws(rng, x.shape, lognorm),)

    return run_fast(lambda p: {k: case(p, *c) for k, c in FM_CASES.items()}, params)


@pytest.mark.parametrize("case", FM_CASES)
def test_flow_matching_loss_and_grads(ldit, fm_want, case):
    _, params, _ = ldit
    lognorm, cosine = FM_CASES[case]
    kw = FLAGS["lightningdit"]
    x, t, y = inputs(3)
    (jloss, jaux), jgrads, draws = fm_want[case]
    pm = to_port(params, **kw).train()
    tdraw, noise, drop = to_torch(draws)
    ploss, paux = transport.flow_matching_loss(
        lambda *a: pm(*a), torch.from_numpy(x), torch.from_numpy(y).long(), tdraw, noise, drop,
        lognorm, cosine)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(paux["mse"].detach()), float(jaux["mse"]), rtol=1e-5)
    want = convert.dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = port_grads(pm)
    assert set(got) == set(want)
    for n in want:
        close(got[n], want[n], 1e-4, n)


@pytest.fixture(scope="module")
def reg_tool():
    """The JAX REG tool; registered as a module, since its build_reg defines
    a Flax dataclass, which looks its module up."""
    mod = load_script("tools/preprocess_for_reg/train.py")
    sys.modules[mod.__name__] = mod
    yield mod
    del sys.modules[mod.__name__]


def reg_cfg(repa_weight):
    return {"model": dict(in_chans=CH, latent_size=GRID, hidden_size=64, depth=2, num_heads=4,
                          repa_weight=repa_weight, repa_block=REPA_BLOCK,
                          repa_target_dim=REPA_DIM),
            "data": {"num_classes": NCLS}}


def repa_setup(reg_tool, seed):
    """The JAX REG model and projector (the tool's build_reg), randomised
    {"dit", "proj"} parameters, and the port's pair on them."""
    from vfm_vae_tpu_torch.tools._dit import build_reg

    model, projector, _, _, w = reg_tool.build_reg(reg_cfg(0.5))
    x, t, y = inputs(seed)
    params = {"dit": init_params(model, seed),
              "proj": draw_params(lambda k: projector.init(
                  k, jnp.zeros((1, GRID * GRID, 64)))["params"], seed + 1)}
    pm, pp, _, _, pw = build_reg(reg_cfg(0.5))
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        convert.dit_state_dict_from_jax(params["dit"]).items()})
    pp.load_state_dict({k: torch.from_numpy(v) for k, v in
                        convert.dit_state_dict_from_jax(params["proj"]).items()})
    assert w == pw == 0.5 and isinstance(pp, REPAProjector)
    return model, projector, params, pm, pp


def test_repa_loss_and_grads(reg_tool):
    """The REG trainer's loss: posterior z, uniform t, cosine and REPA terms."""
    model, projector, params, pm, pp = repa_setup(reg_tool, 7)
    r = np.random.default_rng(8)
    z = r.standard_normal((B, GRID, GRID, CH)).astype(np.float32)
    y = r.integers(0, NCLS, (B,)).astype(np.int32)
    tgt = r.standard_normal((B, GRID * GRID, REPA_DIM)).astype(np.float32)
    rng = jax.random.PRNGKey(9)

    def model_fn(p, xt, tt, yy, rr):
        out, tap = model.apply({"params": p["dit"]}, xt, tt, yy, train=rr is not None, rng=rr)
        return out, projector.apply({"params": p["proj"]}, tap)

    def lf(p):
        return jax_transport.flow_matching_loss(model_fn, p, z, y, rng, use_lognorm=False,
                                                repa_targets=tgt, repa_weight=0.5)

    (jloss, _), jgrads, draws = run_fast(
        lambda p: jax.value_and_grad(lf, has_aux=True)(p) + (jax_draws(rng, z.shape, False),),
        params)
    tr = DiTTrainer(pm.train(), pp, 1e-4, (0.9, 0.999), 1e-4, False, True, 0.5, None)
    ploss = tr.loss(torch.from_numpy(z), torch.from_numpy(y).long(), torch.from_numpy(tgt),
                    to_torch(draws))
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-5)
    g = jax.tree_util.tree_map(np.asarray, jgrads)
    for part, mod in (("dit", pm), ("proj", pp)):
        want, got = convert.dit_state_dict_from_jax(g[part]), port_grads(mod)
        assert set(got) == set(want)
        for n in want:
            close(got[n], want[n], 1e-4, f"{part}.{n}")


ADAMW_LR = 2e-4
ADAMW_B2 = {0.0: 0.95, 1e-4: 0.999}  # the LightningDiT tool's, optax's default (REG)


@pytest.fixture(scope="module")
def adamw_want(ldit):
    """Two gradients, and optax's parameters and EMA after two AdamW + EMA
    steps on them at each decay of ADAMW_B2, one compile."""
    _, params, _ = ldit
    r = np.random.default_rng(13)
    grads = [jax.tree_util.tree_map(
        lambda v: (r.standard_normal(v.shape) * 10.0 ** r.integers(-4, 1)).astype(np.float32),
        params) for _ in range(2)]

    def steps(p0, gs):
        out = {}
        for wd, b2 in ADAMW_B2.items():
            tx = optax.adamw(ADAMW_LR, b1=0.9, b2=b2, weight_decay=wd)
            p, opt, ema = p0, tx.init(p0), p0
            for g in gs:
                updates, opt = tx.update(g, opt, p)
                p = optax.apply_updates(p, updates)
                ema = jax.tree_util.tree_map(lambda e, q: e * 0.9999 + q * 0.0001, ema, p)
            out[wd] = (p, ema)
        return out

    return grads, run_fast(steps, params, grads)


@pytest.mark.parametrize("wd", sorted(ADAMW_B2))
def test_adamw_ema_steps_match_optax(ldit, adamw_want, wd):
    """Two steps of each trainer's update on the same gradients: AdamW (b2
    0.95 with decay 0, as the LightningDiT tool; 0.999 with optax's default
    1e-4, as the REG tool), each followed by the EMA."""
    _, params, _ = ldit
    grads, want = adamw_want
    jp, jema = want[wd]
    pm = to_port(params, **FLAGS["lightningdit"])
    tr = DiTTrainer(pm, None, ADAMW_LR, (0.9, ADAMW_B2[wd]), wd, True, True, 0.0, None)
    named = dict(pm.named_parameters())
    for g in grads:
        for n, v in convert.dit_state_dict_from_jax(g).items():
            named[n].grad = torch.from_numpy(v)
        tr.update()
    for tree, got in ((jp, named), (jema, tr.ema)):
        want = convert.dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        for n in want:
            np.testing.assert_allclose(got[n].detach().numpy(), want[n], rtol=1e-6, atol=1e-8,
                                       err_msg=n)


@pytest.fixture(scope="module")
def ldit():
    """A JAX DiT with the LightningDiT flags, its randomised parameters and
    the port's module on them."""
    jm = JaxDiT(**TINY, **FLAGS["lightningdit"])
    params = init_params(jm, 5)
    return jm, params, to_port(params, **FLAGS["lightningdit"])


ODE_CASES = {"cfg1": (1.0, None), "cfg1.5": (1.5, None), "cfg1.5-interval": (1.5, (0.2, 0.6))}
SHAPE = (B, GRID, GRID, CH)
ODE_RNG, ODE_STEPS, SDE_RNG, SDE_STEPS = 17, 6, 18, 5


@pytest.fixture(scope="module")
def samples_want(ldit):
    """JAX's Euler ODE samples in each ODE_CASES case and its SDE sample
    (cfg 4), with the noise each drew (the ODE's start; the SDE's start and
    each step's), one compile."""
    jm, params, _ = ldit
    y = inputs(14)[2]

    def apply(q, x, t, yy, _):
        return jm.apply({"params": q}, x, t, yy)

    def all_samples(p):
        out = {k: jax_transport.ode_euler_sample(
            apply, p, jax.random.PRNGKey(ODE_RNG), SHAPE, labels=y, num_steps=ODE_STEPS,
            cfg_scale=cfg, cfg_interval=interval) for k, (cfg, interval) in ODE_CASES.items()}
        out["sde"] = jax_transport.sde_sample(apply, p, jax.random.PRNGKey(SDE_RNG), SHAPE,
                                              labels=y, num_steps=SDE_STEPS, cfg_scale=4.0)
        out["ode_x0"] = jax.random.normal(jax.random.PRNGKey(ODE_RNG), SHAPE)
        r_init, r = jax.random.split(jax.random.PRNGKey(SDE_RNG))
        out["sde_x0"], out["sde_noise"] = jax.random.normal(r_init, SHAPE), []
        for _ in range(SDE_STEPS):
            r, sub = jax.random.split(r)
            out["sde_noise"].append(jax.random.normal(sub, SHAPE))
        return out

    return jax.tree_util.tree_map(np.array, run_fast(all_samples, params))


@pytest.mark.parametrize("case", ODE_CASES)
def test_ode_euler_sample_matches_jax(ldit, samples_want, case):
    _, _, pm = ldit
    cfg, interval = ODE_CASES[case]
    y = inputs(14)[2]
    want = samples_want[case]
    x0 = torch.from_numpy(samples_want["ode_x0"])
    got = transport.ode_euler_sample(lambda *a: pm(*a), x0, torch.from_numpy(y).long(),
                                     ODE_STEPS, cfg, interval)
    close(got, want, 1e-4, "ode")


def test_sde_sample_matches_jax(ldit, samples_want):
    _, _, pm = ldit
    y = inputs(14)[2]
    noises = to_torch(samples_want["sde_noise"])
    x0 = torch.from_numpy(samples_want["sde_x0"])
    got = transport.sde_sample(lambda *a: pm(*a), x0, lambda i: noises[i],
                               torch.from_numpy(y).long(), SDE_STEPS, 4.0)
    close(got, samples_want["sde"], 1e-4, "sde")


def write_latent_shards(root, n_files=2, per=10, ch=CH, feats=False):
    r = np.random.default_rng(19)
    os.makedirs(root, exist_ok=True)
    for i in range(n_files):
        d = {"latents": r.standard_normal((per, ch, GRID, GRID)).astype(np.float32),
             "latents_flip": r.standard_normal((per, ch, GRID, GRID)).astype(np.float32),
             "labels": r.integers(0, NCLS, (per,)).astype(np.int64)}
        if feats:
            d["vfm_features"] = r.standard_normal((per, GRID * GRID, REPA_DIM)).astype(np.float16)
        save_file(d, os.path.join(root, f"latents_rank00_shard{i:03d}.safetensors"))
    save_file({"mean": np.zeros((1, ch, 1, 1), np.float32)},
              os.path.join(root, "latents_stats.safetensors"))


def test_latent_batches_match_jax_tool(tmp_path):
    pytest.importorskip("safetensors")
    write_latent_shards(str(tmp_path))
    jt = load_script("tools/preprocess_for_lightningdit/train.py")
    a = jt.latent_batches(str(tmp_path), 3, np.random.default_rng(20))
    b = lightningdit_train.latent_batches(str(tmp_path), 3, np.random.default_rng(20))
    for _ in range(9):  # past one pass over both files
        (xa, ya), (xb, yb) = next(a), next(b)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_moment_batches_match_jax_tool(tmp_path, reg_tool):
    pytest.importorskip("safetensors")
    write_latent_shards(str(tmp_path), ch=2 * CH, feats=True)
    a = reg_tool.moment_batches(str(tmp_path), 4, np.random.default_rng(21))
    b = reg_train.moment_batches(str(tmp_path), 4, np.random.default_rng(21))
    for _ in range(6):
        for u, v in zip(next(a), next(b)):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("mode", ["unbiased", "biased", "distance-agnostic"])
def test_cknna_matches_jax(mode):
    r = np.random.default_rng(22)
    a = r.standard_normal((40, 16)).astype(np.float32)
    b = (a @ r.standard_normal((16, 24)) + 0.5 * r.standard_normal((40, 24))).astype(np.float32)
    kw = dict(topk=5, unbiased=mode != "biased", distance_agnostic=mode == "distance-agnostic")
    want = jax_cknna.cknna(a, b, **kw)
    np.testing.assert_allclose(cknna.cknna(a, b, **kw), want, atol=1e-5)
    if mode == "unbiased":
        np.testing.assert_allclose(cknna.cknna(a, a, **kw), 1.0, atol=1e-5)


def test_alignment_preprocess_matches_jax(tmp_path):
    import PIL.Image

    jt = load_script("tools/evaluate_alignment/preprocess.py")
    r = np.random.default_rng(23)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(4):
        PIL.Image.fromarray(r.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(
            src / f"img{i}.png")
    recs = alignment_preprocess.main(["equivariance", "--input-dir", str(src),
                                      "--output-dir", str(tmp_path / "eq")])
    assert recs == {f"img{i}": jt.get_transformation_params(i, 42) for i in range(4)}
    alignment_preprocess.main(["noise", "--input-dir", str(src), "--output-dir",
                               str(tmp_path / "nz"), "--noise-levels", "0.1", "--resolution", "20"])
    for i in range(4):
        img = np.array(PIL.Image.open(src / f"img{i}.png").convert("RGB"))
        got = np.array(PIL.Image.open(tmp_path / "nz" / "noise_0.100" / f"img{i}.png"))
        np.testing.assert_array_equal(got, jt.apply_noise(img, 0.1, i, 42))
