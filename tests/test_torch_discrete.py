"""The port's discrete (VQ) tokenizer, its conv adapter and pooling
injectors, the D-input blur and the discrete stage-0 step, against the JAX
package on the CPU in fp32.

Quantizer: the port's VectorQuantizerM and the JAX one on the same
codebooks and features, three training calls (f_hat, the VQ and entropy
losses, the usage figure, the indices where the top two codes are apart,
the usage EMA and its counter) and the token round trip.

Generator: the tiny 64 px rig of tests/test_torch_train.py cut to three
synthesis blocks, in discrete mode (attnproj), and in continuous mode with
the conv compress/decompress and the pooling z injectors. JAX variables
come from a seeded port Generator through the JAX importer
(convert_generator) and go back through state_dict_from_jax bit for bit;
z before quantization and the pixels decoded from the port's indices (or
the moments' mean) are held to tests/test_generator_parity.py's
tolerances.

Training: the JAX Trainer's G microbatch (`_g_microbatch`, the weighted
pull, with the draws off) and the JAX
D loss's gradient, with the VQ, entropy and VF terms on and D's input
blurred at sigma 1, against the port's g_gradients and d_gradients; and
two microbatches threaded through the JAX G buffers against the port's
Trainer(num_accumulation=2). One jitted JAX program serves both, compiled
in a thread beside the port's work with XLA's fast compile options.
"""

import threading

import flax.traverse_util as tu
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_accumulation import NoDraws
from tests.test_torch_generator import randomize_zero_init
from tests.test_torch_train import (
    ANCHOR,
    FAST_COMPILE,
    LOSS_KW,
    RES,
    TINY_DINO,
    tiny_kwargs,
    write_siglip,
)
from tests.torch_threads import one_torch_thread  # noqa: F401
from vfm_vae_tpu.models.convert import convert_generator
from vfm_vae_tpu.models.discriminator import ProjectedDiscriminator as JaxD
from vfm_vae_tpu.models.generator import Generator as JaxG
from vfm_vae_tpu.models.generator import trainable_mask
from vfm_vae_tpu.models.generator import trainable_path_predicates as jax_predicates
from vfm_vae_tpu.models.quantize import VectorQuantizerM as JaxVQM
from vfm_vae_tpu.train.loss import TotalLoss as JaxTotalLoss
from vfm_vae_tpu.train.loss import blur_image as jax_blur_image
from vfm_vae_tpu.train.loss import init_loss_state as jax_init_loss_state
from vfm_vae_tpu.train.optim import Adam as JaxAdam
from vfm_vae_tpu.train.train_step import G_STAT_NAMES
from vfm_vae_tpu.train.train_step import Trainer as JaxTrainer
from vfm_vae_tpu.train.train_step import TrainState as JaxTrainState
from vfm_vae_tpu_torch.entry import DISCRETE_LOSS
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.discriminator import ProjectedDiscriminator
from vfm_vae_tpu_torch.models.generator import (
    Generator,
    trainable_names,
    trainable_path_predicates,
)
from vfm_vae_tpu_torch.models.layers import init_parameters
from vfm_vae_tpu_torch.models.quantize import VectorQuantizerM
from vfm_vae_tpu_torch.train.loss import G_TERMS, TotalLoss, blur_image
from vfm_vae_tpu_torch.train.train_step import Trainer

VQ = dict(compression_mode="discrete", vocab_width=16, vocab_size=64, num_codebooks=4,
          use_entropy_loss=True)
CONV = dict(how_to_compress="conv", how_to_decompress="conv", how_to_process_concat_z="pooling")
SMALL = dict(num_blocks=3, add_additional_convnext=False)
# Stage 0's weights in discrete mode, the entropy term weighted so that its
# gradient counts. No perceptual term and a fixed VF weight: LPIPS and the
# adaptive weight's two extra pulls were most of the XLA compile, and
# tests/test_torch_train.py holds both.
DISC_LOSS = dict(LOSS_KW, **DISCRETE_LOSS)
DISC_LOSS.update(entropy_loss_weight=0.1, perceptual_loss_weight=0.0,
                 use_adaptive_vf_loss=False,
                 multiscale_block_indices=[0, 1], multiscale_pixel_loss_weights=[0.1, 0.1])
EQ = (1.0, 0, False)
BLUR = 1.0
MICRO, N_ACC = 2, 2


def to_jax(kw, seed=0):
    """A seeded port Generator's variables as JAX (params, buffers)."""
    pg = Generator(**kw, generator=torch.Generator().manual_seed(seed))
    geo = convert.geometry_from_kwargs(kw)
    return convert_generator(
        {k: v.numpy() for k, v in pg.state_dict().items()},
        how_to_compress=kw.get("how_to_compress", "attnproj"),
        how_to_decompress=kw.get("how_to_decompress", "attnproj"),
        compression_mode=kw.get("compression_mode", "continuous"),
        use_vf_loss=kw.get("use_vf_loss", False), legacy=geo["legacy"],
        z_resolution=geo["z_resolution"], concat_z_block_indices=geo["concat_z_block_indices"],
        block_resolutions=geo["block_resolutions"])


def tree_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ------------------------------------------------------------------ quantizer


def l2n(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def test_quantizer_matches_jax():
    n_cb, size, width = VQ["num_codebooks"], VQ["vocab_size"], VQ["vocab_width"]
    q = VectorQuantizerM(size, width, use_entropy_loss=True, num_codebooks=n_cb)
    init_parameters(q, torch.Generator().manual_seed(3))
    books = [cb.codebook.weight.detach().numpy().copy() for cb in q.codebooks]
    jq = JaxVQM(vocab_size=size, vocab_width=width, use_entropy_loss=True, num_codebooks=n_cb)
    v = {"params": {f"codebook_{i}": {"codebook": b} for i, b in enumerate(books)},
         "buffers": {f"codebook_{i}": {"vocab_usage": np.zeros(size // n_cb, np.float32),
                                       "usage_record_times": np.zeros((), np.int32)}
                     for i in range(n_cb)}}
    r = np.random.default_rng(0)
    step = jax.jit(lambda v, f: jq.apply(v, f, train=True, mutable=["buffers"]))
    for call in range(3):
        f = r.standard_normal((2, 9, width)).astype(np.float32)
        (f_hat, vq, ent, usage), mut = step(v, jnp.asarray(f))
        v = {"params": v["params"], "buffers": mut["buffers"]}
        p_hat, p_vq, p_ent, p_usage = q(torch.from_numpy(f), update_buffers=True)
        np.testing.assert_allclose(p_hat.detach().numpy(), np.asarray(f_hat), rtol=1e-5,
                                   atol=1e-6)
        for got, want in ((p_vq, vq), (p_ent, ent), (p_usage, usage)):
            np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        # Indices: equal wherever the JAX run's top two codes are apart.
        idx = np.asarray(jq.apply(v, jnp.asarray(f), method=jq.f_to_idx))
        p_idx = q.f_to_idx(torch.from_numpy(f)).numpy()
        chunks = np.split(f.reshape(-1, width), n_cb, axis=-1)
        margins = np.stack([np.diff(np.sort(l2n(c.astype(np.float64)) @ l2n(b).T, 1)[:, -2:], 1)[:, 0]
                            for c, b in zip(chunks, books)]).reshape(n_cb, 2, 9).transpose(1, 0, 2)
        clear = margins > 1e-4
        assert clear.mean() > 0.9
        assert np.array_equal(p_idx[clear], idx[clear])
        assert (p_idx != idx).sum() <= 1
        # The token round trip gives the quantized embedding.
        np.testing.assert_allclose(q.idx_to_f(torch.from_numpy(p_idx)).numpy(),
                                   p_hat.detach().numpy(), rtol=1e-5, atol=1e-6)
    for i, cb in enumerate(q.codebooks):  # the EMA after 3 calls: 1.0, then 0.1
        b = v["buffers"][f"codebook_{i}"]
        np.testing.assert_allclose(cb.vocab_usage.numpy(), np.asarray(b["vocab_usage"]),
                                   rtol=1e-5, atol=1e-7)
        assert int(cb.usage_record_times) == int(b["usage_record_times"]) == 3


# ------------------------------------------------------------------ blur


@pytest.mark.parametrize("sigma", (0.5, 1.0, 2.0))
def test_blur_image_matches_jax(sigma):
    img = np.random.default_rng(5).standard_normal((2, 20, 20, 3)).astype(np.float32)
    want = np.asarray(jax_blur_image(jnp.asarray(img), sigma))
    got = blur_image(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, img)


def test_blur_sigma_schedule_matches_jax():
    jl = object.__new__(JaxTotalLoss)
    for fade, init in ((100, 2.0), (1, 2.0), (37, 1.3)):
        jl.blur_fade_kimg, jl.blur_init_sigma = fade, init
        pl = object.__new__(TotalLoss)
        pl.blur_fade_kimg, pl.blur_init_sigma = fade, init
        for nimg in (0, 12_345, 61_800, 250_000):
            assert pl.blur_sigma(nimg) == jl.blur_sigma(nimg), (fade, init, nimg)
    assert pl.blur_sigma(0) == 1.25  # rounded to 0.25 steps


# ------------------------------------------------------------------ rig


def d_variables(jd, seed: int = 4):
    """JAX D variables drawn with numpy on jax.eval_shape's tree (no XLA
    compile of the init): norm scales 1 and biases 0, other biases and the
    tokens N(0, 0.02), weights N(0, 1 / fan) with fan their leading axes'
    size (the heads' spectral convs normalize theirs), the spectral-norm
    u and v unit vectors."""
    shapes = jax.eval_shape(lambda k: jd.init({"params": k}, jnp.zeros((1, RES, RES, 3)),
                                              train=False), jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)
    out = {}
    for col, tree in shapes.items():
        flat = {}
        for k, v in tu.flatten_dict(tree, sep="/").items():
            leaf, norm = k.split("/")[-1], "/bn/" in k or "/norm" in k
            if leaf in ("u", "v"):
                x = r.standard_normal(v.shape)
                x /= np.linalg.norm(x)
            elif norm:
                x = np.full(v.shape, 1.0 if leaf == "weight" else 0.0)
            elif leaf == "weight" or leaf == "patch_weight":
                x = r.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            else:
                x = 0.02 * r.standard_normal(v.shape)
            flat[k] = x.astype(np.float32)
        out[col] = tu.unflatten_dict(flat, sep="/")
    return out["params"], out["buffers"]



def port_trainer(kw, g_sd, d_sd, n_acc):
    G = Generator(**kw)
    D = ProjectedDiscriminator(vfm_name="siglip2", dino_kwargs=TINY_DINO)
    convert.load_state_dict_numpy(G, g_sd)
    convert.load_state_dict_numpy(D, d_sd)
    loss = TotalLoss(G, D, vfm_name="siglip2", lpips_module=None, **DISC_LOSS)
    return Trainer(loss, trainable_names(G, trainable_path_predicates("train_all")),
                   {n for n, _ in D.named_parameters() if not n.startswith("dino.")},
                   batch_size=MICRO * N_ACC, ema_kimg=1.0, num_accumulation=n_acc)


def usage_buffers(G) -> dict:
    return {n: b.clone() for n, b in G.named_buffers() if "quantizer" in n or "x_avg" in n}


def port_side(rig):
    """The port's runs, while XLA compiles the JAX programs."""
    out = {}
    for name, kw in (("vq", rig["kw_vq"]), ("conv", rig["kw_conv"])):
        gp, gb = rig[name]
        G = Generator(**kw)
        convert.load_jax_variables(G, gp, gb, geometry=convert.geometry_from_kwargs(kw))
        img = torch.from_numpy(rig["img"])
        with torch.no_grad():
            feats = G.vfm_encoder.encode_image(img)
            moments = G.ldm_adapter.encode(feats, return_z_before_quantize=True)
        if name == "vq":
            idx = G.ldm_adapter.f_to_idx(feats)
            z = G.ldm_adapter.quantizer.idx_to_f(idx).reshape(moments.shape)
            z_enc = G.encode(img)
        else:
            idx, z_enc = None, None
            z = moments[..., :moments.shape[-1] // 2]
        out[name] = dict(moments=moments.numpy(), idx=idx, z=z, z_enc=z_enc,
                         img=G.decode(z).numpy(), sd=G.state_dict())
    real = torch.from_numpy(rig["real"])
    tr = port_trainer(rig["kw_vq"], rig["g_sd"], rig["d_sd"], 1)
    state = tr.init_state()
    grads, terms, _, stats, _ = tr.g_gradients(state, real[:MICRO], EQ, blur_sigma=BLUR)
    out["g"] = dict(grads={n: g.numpy() for n, g in zip(tr.g_params, grads)},
                    terms=np.array([float(t) for t in terms]),
                    w_vf=float(stats["Loss/G/cur_vf_loss_weight"][1]),
                    usage=float(stats["Loss/G/codebook_usages"][1]), bufs=usage_buffers(tr.G))
    convert.load_state_dict_numpy(tr.D, rig["d_sd"])
    d_grads, d_total, _ = tr.d_gradients(state, real[:MICRO], EQ, blur_sigma=BLUR)
    out["d"] = dict(grads={n: g.numpy() for n, g in zip(tr.d_params, d_grads)},
                    total=float(d_total))
    acc = port_trainer(rig["kw_vq"], rig["g_sd"], rig["d_sd"], N_ACC)
    a_grads, _, a_stats, _ = acc.g_accumulate(acc.init_state(), real, EQ, blur_sigma=BLUR)
    out["acc"] = dict(grads={n: g.numpy() for n, g in zip(acc.g_params, a_grads)},
                      bufs=usage_buffers(acc.G), stats=a_stats)
    return out


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = tmp_path_factory.mktemp("discrete")
    base = dict(tiny_kwargs(write_siglip(root / "siglip2-tiny-patch8-64", RES)), **SMALL)
    kw_vq = dict(base, **VQ)
    kw_conv = dict(base, **CONV)
    r = dict(kw_vq=kw_vq, kw_conv=kw_conv,
             img=np.random.default_rng(1).random((2, RES, RES, 3)).astype(np.float32),
             real=np.random.default_rng(9).random((MICRO * N_ACC, RES, RES, 3))
             .astype(np.float32))
    for name, kw in (("vq", kw_vq), ("conv", kw_conv)):
        gp, gb = to_jax(kw, seed=1 if name == "vq" else 2)
        r[name] = (randomize_zero_init(gp), gb)
    jd = JaxD(c_dim=0, vfm_name="siglip2", dino_kwargs=TINY_DINO)
    dp, db = d_variables(jd)
    gp, gb = r["vq"]
    r["g_sd"] = convert.state_dict_from_jax(gp, gb, geometry=convert.geometry_from_kwargs(kw_vq))
    r["d_sd"] = convert.d_state_dict_from_jax(dp, db)
    r["db"] = db

    # The JAX programs: the tokenizer (z before quantization, the decode of
    # given latents or indices) per configuration, and one microbatch of
    # the G step with D's gradient beside it.
    def tokenizer(jg, discrete):
        def run(v, img, z_or_idx):
            m = jg.apply(v, img, return_z_before_quantize=True, method=jg.encode)
            z = z_or_idx
            if discrete:
                z = jg.apply(v, z_or_idx, method=lambda g, i: g.ldm_adapter.quantizer.idx_to_f(i))
                z = z.reshape(m.shape)
            return m, jg.apply(v, z, method=jg.decode)
        return jax.jit(run)

    jg_vq, jg_conv = JaxG(**kw_vq), JaxG(**kw_conv)
    jloss = JaxTotalLoss(jg_vq, jd, vfm_name="siglip2", lpips_module=None,
                         **{k: v for k, v in DISC_LOSS.items()})
    g_mask = trainable_mask(gp, jax_predicates("train_all"))
    jt = JaxTrainer(NoDraws(jloss), JaxAdam(mask=g_mask), JaxAdam(), g_trainable_mask=g_mask,
                    vf_anchor_path=ANCHOR, batch_size=MICRO * N_ACC, ema_kimg=1.0)
    state = JaxTrainState(g_params=gp, d_params=dp, g_bufs=gb, d_bufs=db, ema_params=None,
                          g_opt=None, d_opt=None, loss_state=None, cur_nimg=jnp.float32(0))

    def microbatch(gp, gb, dp, db, loss_state, real):
        st = state.replace(g_params=gp, d_params=dp)
        grads, gb2, db2, ls2, stats, total, gen_img, _ = jt._g_microbatch(
            gp, st, real, None, jax.random.PRNGKey(0), EQ, BLUR, gb, db, loss_state)
        # D's phase on the image this G makes (d_loss less its own G forward).
        d_grads = jax.grad(lambda p: jloss.d_loss_from_gen(
            p, db, gen_img, real, None, {}, EQ, jnp.float32(0), BLUR)[0])(dp)
        return grads, gb2, db2, ls2, stats, d_grads

    ls0 = jax_init_loss_state()
    chunks = [jnp.asarray(r["real"][i * MICRO:(i + 1) * MICRO]) for i in range(N_ACC)]
    compiled, threads = {}, []

    def compile_in_thread(name, lowered):
        threads.append(threading.Thread(target=lambda: compiled.setdefault(
            name, lowered.compile(FAST_COMPILE))))
        threads[-1].start()

    # The longest compile starts first; the tokenizers trace beside it.
    compile_in_thread("step", jax.jit(microbatch).lower(gp, gb, dp, db, ls0, chunks[0]))
    lowered = {
        "vq": tokenizer(jg_vq, True).lower(
            {"params": gp, "buffers": gb}, jnp.asarray(r["img"]),
            jnp.zeros((2, VQ["num_codebooks"], (RES // 8) ** 2), jnp.int32)),
        "conv": tokenizer(jg_conv, False).lower(
            {"params": r["conv"][0], "buffers": r["conv"][1]}, jnp.asarray(r["img"]),
            jnp.zeros((2, RES // 8, RES // 8, base["z_dimension"]), jnp.float32)),
    }
    for name, low in lowered.items():
        compile_in_thread(name, low)
    try:
        r["port"] = port_side(r)
    finally:
        for t in threads:
            t.join()
    jax_out = {}
    for name in ("vq", "conv"):
        p = r["port"][name]
        arg = (jnp.asarray(p["idx"].numpy().astype(np.int32)) if name == "vq"
               else jnp.asarray(p["z"].numpy()))
        m, img = compiled[name]({"params": r[name][0], "buffers": r[name][1]},
                                jnp.asarray(r["img"]), arg)
        jax_out[name] = dict(moments=np.asarray(m), img=np.asarray(img))
    steps, bufs, dbs, ls = [], gb, db, ls0
    for c in chunks:
        grads, bufs, dbs, ls, stats, d_grads = compiled["step"](gp, bufs, dp, dbs, ls, c)
        steps.append(dict(grads=tree_np(grads), bufs=tree_np(bufs), stats=tree_np(stats),
                          d_grads=tree_np(d_grads)))
    jax_out["steps"] = steps
    r["jax"] = jax_out
    r["jax_stats0"] = steps[0]["stats"]
    return r


def test_bridge_round_trip_is_bit_exact(rig):
    """state_dict_from_jax inverts convert_generator for the quantizer and
    the conv adapter, bit for bit; the port's state_dict has the keys."""
    for name, kw in (("vq", rig["kw_vq"]), ("conv", rig["kw_conv"])):
        gp, gb = rig[name]
        geo = convert.geometry_from_kwargs(kw)
        sd = convert.state_dict_from_jax(gp, gb, geometry=geo)
        assert sorted(sd) == sorted(rig["port"][name]["sd"])
        p2, b2 = convert_generator(
            sd, how_to_compress=kw.get("how_to_compress", "attnproj"),
            how_to_decompress=kw.get("how_to_decompress", "attnproj"),
            compression_mode=kw.get("compression_mode", "continuous"), use_vf_loss=True,
            legacy=geo["legacy"], z_resolution=geo["z_resolution"],
            concat_z_block_indices=geo["concat_z_block_indices"],
            block_resolutions=geo["block_resolutions"])
        for want, got in ((gp, p2), (gb, b2)):
            fw, fg = tu.flatten_dict(want, sep="/"), tu.flatten_dict(got, sep="/")
            assert sorted(fw) == sorted(fg), name
            for k in fw:
                assert np.array_equal(np.asarray(fg[k]), np.asarray(fw[k])), (name, k)
    assert any("quantizer.codebooks.3.vocab_usage" in k for k in rig["port"]["vq"]["sd"])
    assert "ldm_adapter.final_quant.weight" in rig["port"]["conv"]["sd"]


@pytest.mark.parametrize("name", ("vq", "conv"))
def test_z_before_quantize_matches_jax(rig, name):
    got, want = rig["port"][name]["moments"], rig["jax"][name]["moments"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ("vq", "conv"))
def test_decode_matches_jax(rig, name):
    got, want = rig["port"][name]["img"], rig["jax"][name]["img"]
    assert got.shape == (2, RES, RES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_encode_is_the_indices_embedding(rig):
    """Generator.encode's z is the quantized tokens: the embedding of
    f_to_idx's indices up to the straight-through sum's rounding."""
    p = rig["port"]["vq"]
    idx, z, z_enc = p["idx"], p["z"], p["z_enc"]
    assert idx.shape == (2, VQ["num_codebooks"], (RES // 8) ** 2) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < VQ["vocab_size"] // VQ["num_codebooks"]
    assert z_enc.shape == (2, RES // 8, RES // 8, VQ["vocab_width"])
    torch.testing.assert_close(z_enc, z, rtol=0, atol=1e-6)


def test_discrete_g_terms_match_jax(rig):
    got = rig["port"]["g"]
    stats = rig["jax_stats0"]
    want = np.array([float(np.asarray(stats[G_STAT_NAMES[n]])[1]) for n in G_TERMS])
    on = {G_TERMS[i] for i in range(len(G_TERMS)) if want[i] != 0}
    assert on == {"l1_pixel_loss", "multiscale_pixel_loss", "stylegan_t_gen_loss", "vf_loss",
                  "vq_loss", "entropy_loss"}
    np.testing.assert_allclose(got["terms"], want, rtol=1e-4, atol=1e-6)
    assert got["w_vf"] == float(np.asarray(stats["Loss/G/cur_vf_loss_weight"])[1]) == 5.0
    np.testing.assert_allclose(got["usage"], float(np.asarray(stats["Loss/G/codebook_usages"])[1]),
                               rtol=1e-5)


def assert_grads_close(got: dict, want: dict, names):
    for n in names:
        w, g = want[n].reshape(got[n].shape), got[n]
        scale = float(np.abs(w).max())
        assert scale > 0, f"{n}: no gradient in the JAX step"
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * scale, err_msg=n)


def jax_grads_sd(rig, grads, bufs):
    return convert.state_dict_from_jax(grads, bufs,
                                       geometry=convert.geometry_from_kwargs(rig["kw_vq"]))


def test_discrete_g_gradients_match_jax(rig):
    got = rig["port"]["g"]["grads"]
    step = rig["jax"]["steps"][0]
    want = jax_grads_sd(rig, step["grads"], step["bufs"])
    names = sorted(got)
    assert len(names) > 100 and any("quantizer.codebooks.0.codebook" in n for n in names)
    assert "ldm_adapter.linear_proj.weight" in names  # VF through linear_proj, vocab_width wide
    assert_grads_close(got, want, names)


def test_discrete_d_gradients_match_jax(rig):
    got = rig["port"]["d"]["grads"]
    want = convert.d_state_dict_from_jax(rig["jax"]["steps"][0]["d_grads"], rig["db"])
    names = sorted(got)
    assert len(names) > 4
    for n in names:
        w, g = want[n].reshape(got[n].shape), got[n]
        scale = float(np.abs(w).max())
        if n.endswith((".main0.conv.bias", ".main1.conv.bias")):
            # BatchNormLocal-fed biases: zero in exact arithmetic, rounding
            # noise in both packages.
            assert max(float(np.abs(g).max()), scale) < 1e-6, n
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * scale, err_msg=n)


def test_usage_buffers_thread_through_microbatches(rig):
    """One microbatch advances each codebook's usage EMA once (and x_avg);
    Trainer(num_accumulation=2) threads them through both microbatches as
    the JAX step threads g_bufs, and sums the gradients."""
    steps = rig["jax"]["steps"]
    for bufs, want in ((rig["port"]["g"]["bufs"], steps[0]["bufs"]),
                       (rig["port"]["acc"]["bufs"], steps[1]["bufs"])):
        q = want["ldm_adapter"]["quantizer"]
        for i in range(VQ["num_codebooks"]):
            b = q[f"codebook_{i}"]
            pre = f"ldm_adapter.quantizer.codebooks.{i}."
            np.testing.assert_allclose(bufs[pre + "vocab_usage"].numpy(),
                                       np.asarray(b["vocab_usage"]), rtol=1e-5, atol=1e-7)
            assert int(bufs[pre + "usage_record_times"]) == int(b["usage_record_times"])
        np.testing.assert_allclose(bufs["mapping.x_avg"].numpy(),
                                   np.asarray(want["mapping"]["x_avg"]), rtol=1e-4, atol=1e-6)
    assert int(rig["port"]["acc"]["bufs"]["ldm_adapter.quantizer.codebooks.0."
                                         "usage_record_times"]) == N_ACC
    got = rig["port"]["acc"]["grads"]
    summed = jax.tree_util.tree_map(lambda a, b: a + b, steps[0]["grads"], steps[1]["grads"])
    want = jax_grads_sd(rig, summed, steps[1]["bufs"])
    assert_grads_close(got, want, sorted(got))
    assert rig["port"]["acc"]["stats"]["Loss/G/codebook_usages"][0] == N_ACC
