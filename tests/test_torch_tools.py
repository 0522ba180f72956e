"""The port's offline tools (vfm_vae_tpu_torch/tools/) as a whole, on the
CPU at the tiny 64 px geometry of tests/test_torch_recipe.py (z 8 px, the
local SigLIP config.json), every CLI called in process through its
main(argv) with --device cpu and torch on one thread.

The weights: a seeded generator's variables crossed into the JAX layout
(tests/test_torch_generator.py's jax_variables_from_port), the zero-init
branches randomised, and carried back into a port snapshot directory
(G_ema.pt) that the tools load. The data: 10 PNGs of 72 px in two tar
shards (tests.test_data.make_shards), encoded at --batch 4, so the last
batch holds 2.

Against the JAX package (same crops, same weights): the crops byte for
byte; prefetch_reg's moments to 5e-4 (tests/test_generator_parity.py's
encode tolerance); decoded pixels to 2e-3 before quantization and one
uint8 step after; reconstruct's default (posterior mode) likewise.
"""

import ast
import io
import json
import os
import re
from glob import glob

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import PIL.Image
import torch
import yaml

from tests.test_data import make_shards
from tests.test_torch_generator import jax_variables_from_port, randomize_zero_init
from tests.test_torch_metrics import FAST_COMPILE, REPO, load_script
from tests.test_torch_recipe import stage_config, write_siglip
from vfm_vae_tpu.models.distributions import mean_logvar_to_mean_std as jax_mean_std
from vfm_vae_tpu.models.generator import Generator as JaxG
from vfm_vae_tpu_torch.core.config import to_plain
from vfm_vae_tpu_torch.data import safetensors_io
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.generator import Generator
from vfm_vae_tpu_torch.parallel import serving
from vfm_vae_tpu_torch.tools import (
    decode_latents_to_images, decode_latents_to_labels, evaluate, evaluate_npz, extract, fidelity,
    prefetch, prefetch_reg, reconstruct, save_images_as_npz)
from vfm_vae_tpu_torch.tools._generator import EVAL_OVERRIDES, build_generator
from vfm_vae_tpu_torch.train import cli

N_IMAGES, BATCH, RES, ZR, ZDIM = 10, 4, 64, 8, 8
TOOLS = (prefetch, prefetch_reg, decode_latents_to_images, decode_latents_to_labels,
         save_images_as_npz, extract, reconstruct, evaluate, fidelity, evaluate_npz)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the tiny rig (beside pytest-xdist's workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    write_siglip(root / "siglip2-tiny-patch8-64")
    c = stage_config(root, 0)
    cfg = root / "tiny.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(to_plain(c), f)
    gk = {k: v for k, v in c.G_kwargs.items() if k != "class_name"}
    gk.update(EVAL_OVERRIDES)
    gp, gb = jax_variables_from_port(gk, seed=3)
    gp = randomize_zero_init(gp, seed=3)
    pg = Generator(**gk)
    convert.load_jax_variables(pg, gp, gb, geometry=convert.geometry_from_kwargs(gk))
    snap = root / "snapshot"
    snap.mkdir()
    torch.save(pg.state_dict(), snap / "G_ema.pt")
    make_shards(root / "shards", n_shards=2, per_shard=N_IMAGES // 2, size=72)
    base = ["--config", str(cfg), "--snapshot", str(snap), "--device", "cpu"]
    return dict(root=root, c=c, gk=gk, gp=gp, gb=gb, base=base, snap=str(snap),
                shards=str(root / "shards"))


def shard_images(shards):
    """(PIL images, labels) of the rig's tars in the tools' order."""
    from vfm_vae_tpu_torch.data.wds import iter_tar_samples

    out = []
    for tar in sorted(glob(os.path.join(shards, "**", "*.tar"), recursive=True)):
        for raw in iter_tar_samples(tar):
            out.append((PIL.Image.open(io.BytesIO(raw["png"])), int(raw["cls"].decode())))
    return out


@pytest.fixture(scope="module")
def prefetched(rig):
    """prefetch (features and images stored) and prefetch_reg at --batch 4."""
    root = rig["root"]
    common = rig["base"] + ["--data", rig["shards"], "--batch", str(BATCH),
                            "--resolution", str(RES)]
    lat = prefetch.main(common + ["--out", str(root / "lat"), "--store-vfm-features",
                                  "--store-images"])
    reg = prefetch_reg.main(common + ["--out", str(root / "reg")])
    return dict(lat=lat, reg=reg, lat_dir=root / "lat", reg_dir=root / "reg")


@pytest.fixture(scope="module")
def jax_ref(rig):
    """The JAX generator's encode moments of the crops and their flips, and
    its decode, each compiled once."""
    jg = JaxG(**rig["gk"])
    v = {"params": rig["gp"], "buffers": rig["gb"]}
    jcrop = load_script("tools/preprocess_for_lightningdit/prefetch.py").adm_center_crop
    crops = np.stack([jcrop(img, RES) for img, _ in shard_images(rig["shards"])])
    x = np.concatenate([crops, crops[:, :, ::-1]]).astype(np.float32) / 255.0
    enc = jax.jit(lambda v, x: jg.apply(v, x, return_z_before_quantize=True, method=jg.encode))
    moments = np.asarray(enc.lower(v, x).compile(FAST_COMPILE)(v, x))
    z0 = jnp.zeros((N_IMAGES, ZR, ZR, ZDIM))
    dec = jax.jit(lambda v, z: jg.apply(v, z, method=jg.decode)).lower(v, z0).compile(FAST_COMPILE)
    return dict(crops=crops, moments=moments, decode=lambda z: np.asarray(dec(v, jnp.asarray(z))))


def assert_pixels(png: np.ndarray, ref: np.ndarray):
    """PNG (uint8) against the JAX decode in [-1, 1]: one uint8 step."""
    want = ((np.clip(ref, -1, 1) + 1) * 127.5).astype(np.uint8)
    assert png.shape == want.shape
    assert np.abs(png.astype(int) - want.astype(int)).max() <= 1


def read_pngs(paths):
    return np.stack([np.array(PIL.Image.open(p)) for p in paths])


# ------------------------------------------------------------------ crops


def test_crops_match_jax_byte_for_byte(tmp_path):
    jcrop = load_script("tools/preprocess_for_lightningdit/prefetch.py").adm_center_crop
    jload = load_script("tools/reconstruct/reconstruct.py").load_and_crop
    r = np.random.default_rng(0)
    for h, w in ((72, 72), (70, 90), (150, 200), (300, 131)):  # BOX halvings at >= 128
        img = PIL.Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8))
        np.testing.assert_array_equal(prefetch.adm_center_crop(img, RES), jcrop(img, RES))
        path = str(tmp_path / f"{h}x{w}.png")
        img.save(path)
        got = reconstruct.load_and_crop(path, RES)
        assert got.shape == (RES, RES, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jload(path, RES))


# ------------------------------------------------------------------ prefetch


def test_prefetch_file_contract(rig, prefetched):
    files = sorted(os.listdir(prefetched["lat_dir"]))
    assert files == ["images", "latents_rank00_shard000.safetensors", "latents_stats.npz",
                     "latents_stats.safetensors"]
    d = safetensors_io.load_file(str(prefetched["lat_dir"] / files[1]))
    # Every sample, the tail batch of 2 too.
    assert prefetched["lat"]["samples"] == N_IMAGES
    assert d["latents"].shape == d["latents_flip"].shape == (N_IMAGES, ZDIM, ZR, ZR)
    assert d["latents"].dtype == np.float32 and d["labels"].dtype == np.int64
    np.testing.assert_array_equal(d["labels"], [lbl for _, lbl in shard_images(rig["shards"])])
    assert d["vfm_features"].dtype == np.float16 and d["vfm_features"].shape == (
        N_IMAGES, ZR * ZR, 64)
    stats = safetensors_io.load_file(str(prefetched["lat_dir"] / "latents_stats.safetensors"))
    npz = np.load(prefetched["lat_dir"] / "latents_stats.npz")
    for k in ("mean", "std"):
        assert stats[k].shape == (1, ZDIM, 1, 1)
        np.testing.assert_array_equal(stats[k], npz[k])
    np.testing.assert_array_equal(stats["mean"], d["latents"].mean(axis=(0, 2, 3), keepdims=True))
    # The stored images and their dataset json.
    with open(prefetched["lat_dir"] / "images" / "dataset_rank0.json") as f:
        records = json.load(f)["labels"]
    assert len(records) == N_IMAGES
    assert all(os.path.isfile(prefetched["lat_dir"] / "images" / name) for name, _ in records)


def test_prefetch_reg_moments_match_jax(prefetched, jax_ref):
    d = safetensors_io.load_file(str(prefetched["reg_dir"] / "latents_rank00_shard000.safetensors"))
    want = np.asarray(jax_mean_std(jnp.asarray(jax_ref["moments"]))).transpose(0, 3, 1, 2)
    assert d["latents"].shape == (N_IMAGES, 2 * ZDIM, ZR, ZR)
    np.testing.assert_allclose(d["latents"], want[:N_IMAGES], rtol=5e-4, atol=5e-4)
    # The flip is of the width axis (NHWC axis 2).
    np.testing.assert_allclose(d["latents_flip"], want[N_IMAGES:], rtol=5e-4, atol=5e-4)
    assert np.abs(d["latents_flip"] - d["latents"]).max() > 1e-2


def test_prefetch_samples_the_posterior(prefetched):
    """prefetch stores z = mean + std * noise: near the moments' mean, not on it."""
    lat = safetensors_io.load_file(str(prefetched["lat_dir"] / "latents_rank00_shard000.safetensors"))
    reg = safetensors_io.load_file(str(prefetched["reg_dir"] / "latents_rank00_shard000.safetensors"))
    mean, std = reg["latents"][:, :ZDIM], reg["latents"][:, ZDIM:]
    noise = (lat["latents"] - mean) / std
    assert 0.5 < noise.std() < 1.5 and abs(noise.mean()) < 0.2


def test_prefetch_int8_calibrates_once(rig, monkeypatch, tmp_path):
    from vfm_vae_tpu_torch.ops import quantized

    monkeypatch.setenv("VFM_VAE_INT8_VFM", "0")  # restored after enable_int8_tower sets it
    calls = []
    real = quantized.enable_int8_tower

    def counted(G, imgs):
        calls.append(imgs.shape)
        return real(G, imgs)

    monkeypatch.setattr(quantized, "enable_int8_tower", counted)
    out = prefetch.main(rig["base"] + ["--data", rig["shards"], "--batch", str(BATCH),
                                       "--resolution", str(RES), "--out", str(tmp_path), "--int8"])
    assert calls == [(BATCH, RES, RES, 3)]  # the first real batch, once
    assert out["samples"] == N_IMAGES
    lat = safetensors_io.load_file(out["shards"][0])["latents"]
    assert lat.shape == (N_IMAGES, ZDIM, ZR, ZR) and np.isfinite(lat).all()


# ------------------------------------------------------------------ decode


def test_decode_latents_matches_jax(rig, prefetched, jax_ref, tmp_path):
    out = decode_latents_to_images.main(rig["base"] + [
        "--latents", str(prefetched["lat_dir"]), "--out", str(tmp_path), "--batch", str(BATCH)])
    # latents_stats* are not latents: 10 images, named by rank and index.
    assert sorted(os.listdir(tmp_path)) == [f"00_{i:08d}.png" for i in range(N_IMAGES)]
    z = safetensors_io.load_file(prefetched["lat"]["shards"][0])["latents"].transpose(0, 2, 3, 1)
    ref = jax_ref["decode"](z)
    G, _ = build_generator(rig["base"][1], rig["snap"], torch.device("cpu"))
    np.testing.assert_allclose(G.decode(torch.from_numpy(np.ascontiguousarray(z))).numpy(), ref,
                               rtol=2e-3, atol=2e-3)
    assert_pixels(read_pngs(out["files"]), ref)
    labels = decode_latents_to_labels.main(["--latents", str(prefetched["lat_dir"]),
                                            "--out", str(tmp_path / "labels.json")])
    assert list(labels) == [f"00_{i:08d}.png" for i in range(N_IMAGES)]


# ------------------------------------------------------------------ reconstruct


@pytest.fixture(scope="module")
def reconstructed(rig, prefetched):
    out = rig["root"] / "recon"
    res = reconstruct.main(rig["base"] + ["--data", str(prefetched["lat_dir"] / "images"),
                                          "--out", str(out), "--batch", str(BATCH)])
    return dict(res=res, out=out)


def test_reconstruct_default_matches_jax_mode(reconstructed, jax_ref):
    out = reconstructed["out"]
    names = reconstructed["res"]["names"]
    assert names == [f"{i:08d}.png" for i in range(N_IMAGES)]
    # The stored images, walked class folder by class folder: image i has
    # class i here, so the walk keeps the shards' order.
    inputs = read_pngs([out / "inputs" / n for n in names])
    np.testing.assert_array_equal(inputs, jax_ref["crops"])
    mode = jax_ref["moments"][:N_IMAGES, ..., :ZDIM]
    assert_pixels(read_pngs([out / "outputs" / n for n in names]), jax_ref["decode"](mode))


def test_reconstruct_sample_posterior_is_seeded(rig, prefetched, reconstructed, tmp_path):
    runs = []
    for i in range(2):
        reconstruct.main(rig["base"] + ["--data", str(prefetched["lat_dir"] / "images"),
                                        "--out", str(tmp_path / str(i)), "--batch", str(BATCH),
                                        "--sample-posterior", "--max-images", "4"])
        runs.append(read_pngs(sorted((tmp_path / str(i) / "outputs").iterdir())))
    np.testing.assert_array_equal(runs[0], runs[1])
    mode = read_pngs(sorted((reconstructed["out"] / "outputs").iterdir())[:4])
    assert np.abs(runs[0].astype(int) - mode.astype(int)).max() > 1


# ------------------------------------------------------------------ evaluation tools


def test_evaluation_tools_print_the_jax_keys(reconstructed, tmp_path, capsys, monkeypatch):
    """evaluate, fidelity and evaluate_npz on the reconstruction pairs. The
    detector is the real InceptionV3 (random weights) with its pool and
    sFID features cut to their first 64 dimensions: scipy's sqrtm of a
    2048 x 2048 product takes about 13 s on one CPU, and the Frechet
    distance is tested at full width in tests/test_torch_metrics.py's
    parts."""
    from vfm_vae_tpu_torch.metrics import inception

    full = inception.make_detector

    def cut(weights, device, tool):
        model, fn = full(weights, device, tool)
        return model, lambda x: (lambda p, lg, sp: (p[:, :64], lg, sp[:, :64]))(*fn(x))

    monkeypatch.setattr(inception, "make_detector", cut)
    out = reconstructed["out"]
    ev = evaluate.main(["--inputs", str(out / "inputs"), "--outputs", str(out / "outputs"),
                        "--allow-random-lpips", "--device", "cpu", "--batch", "4"])
    printed = capsys.readouterr()
    assert set(ev["results"]) == {"psnr", "ssim", "lpips"}
    assert [ln.split(":")[0] for ln in printed.out.splitlines()
            if not ln.startswith("[")] == ["psnr", "ssim", "lpips"]
    assert "random-init LPIPS" in printed.err
    same = evaluate.main(["--inputs", str(out / "inputs"), "--outputs", str(out / "inputs"),
                          "--device", "cpu"])["results"]
    assert same == {"psnr": pytest.approx(120.0), "ssim": pytest.approx(1.0)}

    fi = fidelity.main(["--input1", str(out / "outputs"), "--input2", str(out / "inputs"),
                        "--fid", "--isc", "--max", "4", "--device", "cpu"])
    printed = capsys.readouterr()
    assert set(json.loads(printed.out.splitlines()[-2])) == {"rfid", "is_mean", "is_std"}
    assert "random-init InceptionV3" in printed.err
    assert all(np.isfinite(v) for v in fi["results"].values())

    npz = {}
    for side in ("inputs", "outputs"):
        npz[side] = str(tmp_path / f"{side}.npz")
        assert save_images_as_npz.main(["--images", str(out / side), "--out", npz[side]]) == (
            N_IMAGES, RES, RES, 3)
    en = evaluate_npz.main(["--sample-batch", npz["outputs"], "--ref-batch", npz["inputs"],
                            "--max-items", "4", "--device", "cpu"])
    printed = capsys.readouterr()
    assert set(json.loads(printed.out.splitlines()[-2])) == {
        "fid", "sfid", "inception_score", "precision", "recall", "n_samples", "n_ref"}
    assert en["results"]["n_samples"] == en["results"]["n_ref"] == 4
    assert "random-init InceptionV3" in printed.err


# ------------------------------------------------------------------ plumbing


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tool_help_states_no_tpu_figure(tool, capsys):
    with pytest.raises(SystemExit) as e:
        tool.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    assert "usage:" in text and not re.search(r"\b(TPU|v5e|v6e)\b", text)


def test_tools_need_the_card_unless_asked_for_the_cpu(rig, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools run on it")
    for tool, extra in ((prefetch, ["--data", rig["shards"], "--out", str(tmp_path)]),
                        (reconstruct, ["--data", rig["shards"], "--out", str(tmp_path)]),
                        (decode_latents_to_images, ["--latents", str(tmp_path),
                                                    "--out", str(tmp_path)])):
        argv = rig["base"][:4] + extra  # no --device: the card
        with pytest.raises(SystemExit, match=f"{tool.__name__.rsplit('.', 1)[-1]}: no CUDA"):
            tool.main(argv)
    with pytest.raises(SystemExit, match="fidelity: no CUDA"):
        fidelity.main(["--input1", str(tmp_path), "--isc"])


def test_process_shard_splits_by_rank(monkeypatch):
    assert serving.process_shard(range(7)) == list(range(7))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert serving.rank_and_world() == (1, 3)
    assert serving.process_shard(range(7)) == [1, 4]
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(ValueError):
        serving.process_shard(range(7))
    assert [len(b) for b in serving.batched(range(10), 4)] == [4, 4, 2]


def test_safetensors_files_interoperate(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    r = np.random.default_rng(0)
    tensors = {"latents": r.standard_normal((3, 4, 2, 2)).astype(np.float32),
               "labels": np.arange(3, dtype=np.int64),
               "vfm_features": r.standard_normal((3, 4, 5)).astype(np.float16),
               "u8": r.integers(0, 255, (7,), dtype=np.uint8)}
    safetensors_io.save_file(tensors, str(tmp_path / "port.safetensors"))
    back = st.load_file(str(tmp_path / "port.safetensors"))
    st.save_file(tensors, str(tmp_path / "lib.safetensors"))
    ours = safetensors_io.load_file(str(tmp_path / "lib.safetensors"))
    for got in (back, ours):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)


def test_extract_untars_the_images(rig, tmp_path):
    assert extract.main(["--tars", rig["shards"], "--out", str(tmp_path)]) == N_IMAGES
    assert len(os.listdir(tmp_path)) == N_IMAGES


def test_loop_writes_recon_suite(rig, capsys):
    """One tick of stage 0 with metrics: recon_suite is written to
    metric-recon_suite.jsonl; a metric the loop does not run is skipped
    with a warning."""
    c = stage_config(rig["root"], 0)
    c.update(metrics=["recon_suite", "fid50k_full"], in_loop_metric_batches=1,
             image_snapshot_ticks=0)
    c.run_dir = str(rig["root"] / "loop")
    c.training_set_kwargs.path = rig["shards"]
    path = rig["root"] / "loop.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(to_plain(c), f)
    cli.main(["--config", str(path), "--max-steps", "1", "--device", "cpu"])
    with open(os.path.join(c.run_dir, "metric-recon_suite.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert len(lines) == 1
    rec = lines[0]
    assert rec["metric"] == "recon_suite" and rec["snapshot_pkl"].endswith("network-snapshot-00000000")
    assert set(rec["results"]) == {"psnr", "ssim", "lpips", "num_val_images"}
    assert rec["results"]["num_val_images"] == c.batch_size
    assert all(np.isfinite(v) for v in rec["results"].values())
    assert "metric 'fid50k_full' is offline-only" in capsys.readouterr().out


def test_port_imports_no_jax():
    """No module of the port imports jax, flax or the JAX package (ast walk)."""
    pkg = os.path.join(REPO, "vfm_vae_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                    mods = [node.module]
                for m in mods:
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "vfm_vae_tpu"):
                        bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {m}")
    assert not bad, bad
