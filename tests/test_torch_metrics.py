"""The port's evaluation metrics (vfm_vae_tpu_torch/metrics/) against the
JAX package on the CPU, on the same seeded numpy inputs and the same
weights (crossed through the port's converters).

Tolerances: the numpy and scipy code that both packages run the same way
(FeatureStats, the Frechet distance, the IS splits, the registry's
dataset metrics) to 1e-10; PSNR, SSIM and LPIPS (fp32, sums in another
order) 1e-5 relative; InceptionV3's pool features, logits and sFID tap
1e-4 rel-L1 (about 95 fp32 convolutions in a row, each summed in another
order); precision and recall exactly, on features in general position (no
distance within rounding of a radius).
"""

import importlib.util
import os
import zipfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import PIL.Image
import torch

from vfm_vae_tpu.metrics import feature_stats as jax_fs
from vfm_vae_tpu.metrics import fid as jax_fid
from vfm_vae_tpu.metrics import metric_main as jax_mm
from vfm_vae_tpu.metrics import precision_recall as jax_pr
from vfm_vae_tpu.metrics import recon as jax_recon
from vfm_vae_tpu.metrics.inception import InceptionV3Features as JaxInception
from vfm_vae_tpu.train.lpips import LPIPS as JaxLPIPS
from vfm_vae_tpu_torch.metrics import feature_stats, fid, metric_main, precision_recall, recon
from vfm_vae_tpu_torch.metrics.inception import InceptionV3Features
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.train.lpips import LPIPS

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(rel: str):
    """A JAX tool script (tools/..., not a package) as a module; the scripts
    import only the standard library, numpy and PIL at their top."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + rel.replace("/", "_")[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel_l1(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops beside pytest-xdist's busy workers: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ PSNR, SSIM, LPIPS


def lpips_pair():
    """JAX LPIPS params from the init's shapes (eval_shape: no compile),
    filled from numpy; the port's LPIPS with the same weights."""
    jl = JaxLPIPS()
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(jl.init, jax.random.key(0), x, x)["params"]
    r = np.random.default_rng(11)

    def leaf(path, v):
        fan_in = np.prod(v.shape[:-1]) if v.ndim > 1 else 1
        scale = 1 / np.sqrt(fan_in) if v.ndim > 1 else 0.02
        return np.abs(r.standard_normal(v.shape) * scale).astype(np.float32) \
            if str(path[-1].key).startswith("lin") else \
            (r.standard_normal(v.shape) * scale).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    pl = LPIPS()
    convert.load_state_dict_numpy(pl, convert.lpips_state_dict_from_jax(params))
    return jl, params, pl


def test_psnr_ssim_lpips_match_jax():
    """evaluate_pairs against the JAX function (PSNR and SSIM means), and
    LPIPS image by image against the JAX module compiled without XLA's
    expensive passes (the JAX function compiles VGG16 in full: 7 s)."""
    r = np.random.default_rng(0)
    pairs = []
    for b in (3, 2):  # a second, smaller batch: the means weight by batch size
        real = r.random((b, 32, 32, 3)).astype(np.float32)
        gen = np.clip(real + 0.1 * r.standard_normal(real.shape), 0, 1).astype(np.float32)
        pairs.append((real, gen))
    jl, params, pl = lpips_pair()
    want = jax_recon.evaluate_pairs(pairs, None, None)
    got = recon.evaluate_pairs(pairs, pl)
    assert set(got) == set(want) | {"lpips"} == {"psnr", "ssim", "lpips"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    real, gen = (np.concatenate(x) for x in zip(*pairs))
    args = (params, jnp.asarray(real * 2 - 1), jnp.asarray(gen * 2 - 1))
    per_image = jax.jit(lambda p, a, b: jl.apply({"params": p}, a, b)).lower(*args).compile(
        FAST_COMPILE)(*args)
    with torch.no_grad():
        mine = pl(torch.from_numpy(real * 2 - 1), torch.from_numpy(gen * 2 - 1)).numpy()
    np.testing.assert_allclose(mine, np.asarray(per_image), rtol=1e-5)
    np.testing.assert_allclose(got["lpips"], float(np.asarray(per_image).mean()), rtol=1e-5)
    # Per image, and the clamp of identical images.
    a, b = (torch.from_numpy(p) for p in pairs[0])
    np.testing.assert_allclose(recon.psnr(a, b).numpy(),
                               np.asarray(jax_recon.psnr(jnp.asarray(a.numpy()),
                                                         jnp.asarray(b.numpy()))), rtol=1e-5)
    np.testing.assert_allclose(recon.psnr(a, a).numpy(), 120.0, rtol=1e-6)


# ------------------------------------------------------------------ FID, P/R, IS


def test_feature_stats_and_frechet_match_jax(tmp_path):
    r = np.random.default_rng(1)
    x = r.standard_normal((300, 12)).astype(np.float32)
    y = (r.standard_normal((300, 12)) * 1.3 + 0.2).astype(np.float32)
    stats = []
    for mod in (feature_stats, jax_fs):
        s = [mod.FeatureStats(capture_all=True, capture_mean_cov=True, max_items=290)
             for _ in range(2)]
        for i in range(0, 300, 64):
            s[0].append(x[i : i + 64])
            s[1].append(y[i : i + 64])
        stats.append(s)
    (pa, pb), (ja, jb) = stats
    assert pa.num_items == 290 and pa.is_full()
    # Streaming equals the direct statistics of the same rows.
    mu, cov = pa.get_mean_cov()
    np.testing.assert_allclose(mu, x[:290].astype(np.float64).mean(0), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cov, np.cov(x[:290].astype(np.float64), rowvar=False, bias=True),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(pa.get_all(), ja.get_all())
    # Save and load keep everything the distance reads.
    pa.save(str(tmp_path / "a.npz"))
    back = feature_stats.FeatureStats.load(str(tmp_path / "a.npz"))
    assert back.num_items == 290
    np.testing.assert_array_equal(back.get_all(), pa.get_all())
    want = jax_fid.compute_fid_from_stats(ja, jb)
    assert want > 1.0
    np.testing.assert_allclose(fid.compute_fid_from_stats(back, pb), want, rtol=1e-10)
    np.testing.assert_allclose(fid.frechet_distance(*pa.get_mean_cov(), *pa.get_mean_cov()), 0.0,
                               atol=1e-8)


def test_frechet_offsets_a_product_without_a_finite_root(monkeypatch):
    """Where sqrtm gives NaN (newer scipy, on some singular products), the
    root is taken again with SQRTM_EPS on both diagonals, as pytorch-fid
    does; where it is finite, nothing changes."""
    r = np.random.default_rng(7)
    a, b = r.standard_normal((5, 12)), r.standard_normal((5, 12))
    s1, s2 = np.cov(a, rowvar=False, bias=True), np.cov(b, rowvar=False, bias=True)
    mu1, mu2 = a.mean(0), b.mean(0)
    sqrtm = fid.scipy.linalg.sqrtm
    eye = np.eye(12) * fid.SQRTM_EPS
    want = float(np.real(np.square(mu1 - mu2).sum() + np.trace(
        s1 + s2 - 2 * sqrtm((s1 + eye) @ (s2 + eye)))))
    calls = []

    def nan_first(x):
        calls.append(x)
        return np.full_like(x, np.nan) if len(calls) == 1 else sqrtm(x)

    monkeypatch.setattr(fid.scipy.linalg, "sqrtm", nan_first)
    assert fid.frechet_distance(mu1, s1, mu2, s2) == want
    assert len(calls) == 2


def test_precision_recall_matches_jax():
    r = np.random.default_rng(2)
    real = r.standard_normal((200, 16)).astype(np.float32)
    gen = (r.standard_normal((150, 16)) * 1.2 + 0.3).astype(np.float32)
    want = jax_pr.compute_pr(real, gen, nhood_size=3)
    got = precision_recall.compute_pr(real, gen, nhood_size=3)
    assert 0 < want[0] < 1 and 0 < want[1] < 1
    assert got == want
    np.testing.assert_allclose(precision_recall.kth_nn_distance(real, 3),
                               jax_pr.kth_nn_distance(real, 3), rtol=1e-5)


def test_inception_scores_match_jax():
    from vfm_vae_tpu_torch.tools.evaluate_npz import inception_score as adm_is

    jax_adm_is = load_script("tools/decode/evaluate_npz.py").inception_score

    r = np.random.default_rng(3)
    logits = r.standard_normal((23, 10)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (1, 4):
        want = jax_mm.calc_metric("inception_score", probs=probs, num_splits=splits)["results"]
        got = metric_main.calc_metric("inception_score", probs=probs,
                                      num_splits=splits)["results"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-10)
    for split in (5000, 7):
        np.testing.assert_allclose(adm_is(probs, split), jax_adm_is(probs, split), rtol=1e-10)


# ------------------------------------------------------------------ InceptionV3


def inception_variables(seed: int = 4):
    """The JAX detector's variables from its init's shapes (eval_shape: no
    compile), filled from numpy: He-scaled kernels, BatchNorm statistics and
    affine away from (0, 1) so that the BN order shows, a random head."""
    model = JaxInception(return_logits=True)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 299, 299, 3)))
    r = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(path[-1].key)
        if v.ndim > 1:
            x = r.standard_normal(v.shape) * np.sqrt(2.0 / np.prod(v.shape[:-1]))
        elif name in ("bn_weight", "bn_var"):
            x = r.uniform(0.5, 1.5, v.shape)
        else:
            x = 0.1 * r.standard_normal(v.shape)
        return x.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(leaf, shapes)


def test_inception_matches_jax():
    model, v = inception_variables()
    x = np.random.default_rng(5).random((2, 64, 64, 3)).astype(np.float32)

    def run(variables, x):
        (pool, logits), inter = model.apply(variables, x, mutable=["intermediates"])
        sp = inter["intermediates"]["sfid_spatial"][0]
        return pool, logits, sp.reshape(sp.shape[0], -1)

    want = jax.jit(run).lower(v, x).compile(FAST_COMPILE)(v, x)
    pm = InceptionV3Features()
    sd = convert.inception_state_dict_from_jax(v["params"], v["buffers"])
    # pytorch-fid's layout: load_state_dict as it is (num_batches_tracked absent).
    pm.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()})
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for name, g, w in zip(("pool", "logits", "sfid"), got, want):
        assert g.shape == w.shape, name
        assert rel_l1(g.numpy(), w) <= 1e-4, (name, rel_l1(g.numpy(), w))
    assert got[2].shape == (2, 17 * 17 * 7)


# ------------------------------------------------------------------ the registry


def test_registry_names_match_jax():
    assert metric_main.list_metrics() == jax_mm.list_metrics()


def test_fid10k_full_over_a_zip_matches_jax(tmp_path):
    """The dataset metric over a tiny ImageFolderDataset zip with its md5
    stat cache, the same detector on both sides (a fixed projection of the
    pixels): the same value, the same cache file name, and the second call
    read from the cache."""
    r = np.random.default_rng(6)
    zpath = tmp_path / "data.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for i in range(20):
            img = PIL.Image.fromarray(r.integers(0, 256, (16, 16, 3), dtype=np.uint8))
            with z.open(f"sub/img{i:03d}.png", "w") as f:
                img.save(f, format="PNG")
    proj = r.standard_normal((16 * 16 * 3, 6)).astype(np.float32)

    def detector(imgs):
        x = np.asarray(imgs, np.float32) / 255.0
        return x.reshape(x.shape[0], -1) @ proj

    gen = [r.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8) for _ in range(3)]
    out = {}
    for name, mm in (("port", metric_main), ("jax", jax_mm)):
        cache = tmp_path / f"cache_{name}"
        first = mm.calc_metric("fid10k_full", detector_fn=detector, dataset_path=str(zpath),
                               gen_batches=iter(gen), cache_dir=str(cache))["results"]
        files = sorted(os.listdir(cache))
        assert len(files) == 1
        out[name] = (first["fid10k_full"], files)
    assert out["port"][1] == out["jax"][1]
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-10)
    # The cache answers the second call: the zip may be gone.
    os.remove(zpath)
    again = metric_main.calc_metric("fid10k_full", detector_fn=detector, dataset_path=str(zpath),
                                    gen_batches=iter(gen),
                                    cache_dir=str(tmp_path / "cache_port"))["results"]
    assert again["fid10k_full"] == out["port"][0]
