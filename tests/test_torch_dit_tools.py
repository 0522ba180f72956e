"""The port's latent-diffusion CLIs chained on the CPU, port only, through
each tool's main(argv) with --device cpu and torch on one thread: the
LightningDiT trainer on the stage-0 YAML cut to the "T" size -> its
snapshot -> the ODE sampler through the tiny tokenizer of
tests/test_torch_tools.py (64 px, z 8 px of 8 channels; seeded random
weights) -> PNGs; the REG trainer on the REG YAML with REPA -> the SDE
sampler on the {"dit", "proj"} snapshot; the alignment extractor in the
dit, reg and vae modes -> alignment_metrics. The latent and moment shards
are random and written here.

Two faults of the JAX tools that the port does not copy have a test each:
the LightningDiT sampler de-normalises without undoing latent_multiplier,
and the REG sampler hands a REPA snapshot's whole {"dit", "proj"} tree to
the model.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import PIL.Image
import torch
import yaml

from tests.test_torch_recipe import REPO, stage_config, write_siglip
from vfm_vae_tpu_torch.core.config import to_plain
from vfm_vae_tpu_torch.core.registry import construct_class_by_name
from vfm_vae_tpu_torch.data.safetensors_io import save_file
from vfm_vae_tpu_torch.metrics import cknna
from vfm_vae_tpu_torch.models.generator import Generator
from vfm_vae_tpu_torch.tools import (
    alignment_extract, alignment_metrics, alignment_preprocess, lightningdit_sample,
    lightningdit_train, reg_sample, reg_train)
from vfm_vae_tpu_torch.tools._dit import build_dit, sample_latents, snapshot_params, tool_config
from vfm_vae_tpu_torch.train.checkpoint import load_snapshot

ZR, ZDIM, N_LAT, FEAT_DIM, NCLS = 8, 8, 12, 16, 10
DIT_TOOLS = (lightningdit_train, lightningdit_sample, reg_train, reg_sample,
             alignment_preprocess, alignment_extract, alignment_metrics)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_shards(root, channels, feats):
    """Two shards of N_LAT / 2 random latents (NCHW) with labels, flips and,
    with `feats`, fp16 REPA targets; latents_stats.npz of the first."""
    r = np.random.default_rng(channels)
    os.makedirs(root, exist_ok=True)
    first = None
    for s in range(2):
        n = N_LAT // 2
        d = {"latents": (r.standard_normal((n, channels, ZR, ZR)) * 2 + 0.5).astype(np.float32),
             "latents_flip": r.standard_normal((n, channels, ZR, ZR)).astype(np.float32),
             "labels": r.integers(0, NCLS, (n,)).astype(np.int64)}
        if channels == 2 * ZDIM:  # (mean || std): a positive std
            d["latents"][:, ZDIM:] = np.abs(d["latents"][:, ZDIM:])
            d["latents_flip"][:, ZDIM:] = np.abs(d["latents_flip"][:, ZDIM:])
        if feats:
            d["vfm_features"] = r.standard_normal((n, ZR * ZR, FEAT_DIM)).astype(np.float16)
        save_file(d, os.path.join(root, f"latents_rank00_shard{s:03d}.safetensors"))
        first = d["latents"] if first is None else first
    np.savez(os.path.join(root, "latents_stats.npz"), mean=first.mean((0, 2, 3), keepdims=True),
             std=first.std((0, 2, 3), keepdims=True))


def dump(cfg, path):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = tmp_path_factory.mktemp("dit_tools")
    write_siglip(root / "siglip2-tiny-patch8-64")
    c = stage_config(root, 0)
    vae_cfg = dump(to_plain(c), root / "tiny.yaml")
    gk = {k: v for k, v in c.G_kwargs.items() if k != "class_name"}
    G = construct_class_by_name(class_name=c.G_kwargs["class_name"], dtype=torch.float32,
                                device="cpu", generator=torch.Generator().manual_seed(0), **gk)
    snap = root / "vae_snapshot"
    snap.mkdir()
    torch.save(G.state_dict(), snap / "G_ema.pt")
    write_shards(root / "lat", ZDIM, feats=False)
    write_shards(root / "reg", 2 * ZDIM, feats=True)

    with open(os.path.join(REPO, "tools/preprocess_for_lightningdit/"
                           "train_lightningdit_xl_1_stage_0.yaml")) as f:
        dit = yaml.safe_load(f)
    dit["data"].update(data_path=str(root / "lat"), image_size=64, num_classes=NCLS)
    dit["vae"]["downsample_ratio"] = 8
    dit["model"].update(model_type="LightningDiT-T/1", in_chans=ZDIM)
    dit["train"].update(global_batch_size=4, output_dir=str(root / "runs"), log_every=1,
                        ckpt_every=2)
    with open(os.path.join(REPO, "tools/preprocess_for_reg/train_reg_sit_xl_1.yaml")) as f:
        reg = yaml.safe_load(f)
    reg["data"].update(data_path=str(root / "reg"), num_classes=NCLS)
    reg["model"].update(in_chans=ZDIM, latent_size=ZR, hidden_size=64, depth=2, num_heads=4,
                        repa_weight=0.5, repa_block=0, repa_target_dim=FEAT_DIM)
    reg["train"].update(global_batch_size=4, output_dir=str(root / "runs"), log_every=1,
                        ckpt_every=2)
    return dict(root=root, vae=["--vae-config", vae_cfg, "--vae-snapshot", str(snap)],
                vae_cfg=vae_cfg, vae_snap=str(snap), dit=dit, reg=reg,
                dit_cfg=dump(dit, root / "dit.yaml"), reg_cfg=dump(reg, root / "reg.yaml"))


@pytest.fixture(scope="module")
def dit_run(rig):
    return lightningdit_train.main(["--config", rig["dit_cfg"], "--max-steps", "3",
                                    "--device", "cpu"])


@pytest.fixture(scope="module")
def reg_run(rig):
    return reg_train.main(["--config", rig["reg_cfg"], "--max-steps", "3", "--device", "cpu"])


def test_lightningdit_train_writes_its_snapshot(rig, dit_run, capsys):
    losses, snaps = dit_run["losses"], dit_run["snapshots"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert [os.path.basename(s) for s in snaps] == ["network-snapshot-00000002"]
    snap = load_snapshot(snaps[0])
    assert set(snap) == {"params", "ema"}
    tr = dit_run["trainer"]
    assert set(snap["params"]) == {n for n, _ in tr.model.named_parameters()}
    moved = [n for n, v in snap["ema"].items() if not torch.equal(v, snap["params"][n])]
    assert moved  # the EMA trails the parameters
    model, *_ = build_dit(rig["dit"])
    model.load_state_dict(snap["ema"])  # the sampler's model takes the snapshot strictly


@pytest.mark.parametrize("stage", [0, 1])
def test_trainer_prints_json_lines(rig, tmp_path, capsys, stage):
    """Both published LightningDiT stage YAMLs (stage 1: uniform times)."""
    with open(os.path.join(REPO, "tools/preprocess_for_lightningdit/"
                           f"train_lightningdit_xl_1_stage_{stage}.yaml")) as f:
        pub = yaml.safe_load(f)
    cfg = dict(pub, data=dict(pub["data"], **{k: rig["dit"]["data"][k] for k in
                                              ("data_path", "image_size", "num_classes")}),
               vae=rig["dit"]["vae"], model=dict(pub["model"], **{k: rig["dit"]["model"][k] for k in
                                                                  ("model_type", "in_chans")}),
               train=dict(rig["dit"]["train"], output_dir=str(tmp_path)))
    out = lightningdit_train.main(["--config", dump(cfg, tmp_path / "c.yaml"), "--max-steps", "2",
                                   "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert all(set(ln) == {"step", "loss", "sec"} for ln in lines)
    assert out["trainer"].use_lognorm == (stage == 0)


def test_ode_sampler_writes_pngs_and_replays(rig, dit_run, tmp_path):
    out = lightningdit_sample.main(["--config", rig["dit_cfg"], "--dit-snapshot",
                                    dit_run["snapshots"][0], *rig["vae"], "--out",
                                    str(tmp_path), "--num", "3", "--batch", "2", "--steps", "3",
                                    "--cfg", "1.5", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == [f"{i:06d}.png" for i in range(3)]
    assert np.array(PIL.Image.open(tmp_path / "000002.png")).shape == (64, 64, 3)
    # The same draws in process: labels, then the start noise, batch by batch.
    model, size, ch, ncls = build_dit(rig["dit"])
    model.load_state_dict(snapshot_params(dit_run["snapshots"][0])[0])
    gen = torch.Generator().manual_seed(0)
    zs = []
    for n in (2, 1):
        y = torch.randint(0, ncls, (n,), generator=gen)
        zs.append(sample_latents(lambda *a: model(*a), gen, y, (n, size, size, ch), "ode", 3, 1.5))
    assert torch.equal(out["latents"], torch.cat(zs))


def decode_inputs(monkeypatch):
    seen = []
    orig = Generator.decode

    def spy(self, z, *a, **k):
        seen.append(z.clone())
        return orig(self, z, *a, **k)

    monkeypatch.setattr(Generator, "decode", spy)
    return seen


def test_sampler_undoes_the_latent_multiplier(rig, dit_run, tmp_path, monkeypatch):
    """The trainer feeds (x - mean) / std * latent_multiplier; the sampler
    decodes z / latent_multiplier * std + mean. The JAX sampler decodes
    z * std + mean (sample.py:102), which is the same only at 1.0."""
    cfg = dict(rig["dit"], data=dict(rig["dit"]["data"], latent_multiplier=2.0))
    seen = decode_inputs(monkeypatch)
    out = lightningdit_sample.main(["--config", dump(cfg, tmp_path / "m.yaml"), "--dit-snapshot",
                                    dit_run["snapshots"][0], *rig["vae"], "--out",
                                    str(tmp_path / "png"), "--num", "2", "--batch", "2",
                                    "--steps", "2", "--device", "cpu"])
    st = np.load(os.path.join(rig["dit"]["data"]["data_path"], "latents_stats.npz"))
    mean = torch.from_numpy(st["mean"].transpose(0, 2, 3, 1))
    std = torch.from_numpy(st["std"].transpose(0, 2, 3, 1))
    z = out["latents"]
    torch.testing.assert_close(seen[0], z / 2.0 * std + mean, rtol=0, atol=0)
    assert not torch.allclose(seen[0], z * std + mean)


def test_reg_train_with_repa_writes_the_split_tree(reg_run):
    losses, snaps = reg_run["losses"], reg_run["snapshots"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    snap = load_snapshot(snaps[0])
    assert set(snap["params"]) == set(snap["ema"]) == {"dit", "proj"}
    assert set(snap["params"]["proj"]) == {"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    tr = reg_run["trainer"]
    assert tr.opt.defaults["weight_decay"] == 1e-4 and tr.opt.defaults["betas"] == (0.9, 0.999)
    assert tr.model.pos_embed is not None and tr.model.return_features_at == 0


def test_reg_sampler_takes_the_dit_part(rig, reg_run, tmp_path, monkeypatch):
    """The REG sampler (SDE) on a REPA snapshot applies params["dit"] and
    decodes z as the REG trainer sees it (no stats: the shards' stats are
    the moments' 16 channels). The whole {"dit", "proj"} tree, which the JAX
    tool hands the model, does not load into it."""
    seen = decode_inputs(monkeypatch)
    out = reg_sample.main(["--config", rig["reg_cfg"], "--dit-snapshot", reg_run["snapshots"][0],
                           *rig["vae"], "--out", str(tmp_path), "--num", "2", "--batch", "2",
                           "--steps", "3", "--cfg", "4.0", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["000000.png", "000001.png"]
    assert torch.equal(seen[0], out["latents"]) and out["latents"].shape == (2, ZR, ZR, ZDIM)
    model = reg_run["trainer"].model
    whole = load_snapshot(reg_run["snapshots"][0])["ema"]
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(whole)


def test_alignment_chain(rig, dit_run, reg_run, tmp_path):
    """dit, reg (with projector_0) and vae features -> CKNNA; a feature set
    against itself is 1, and the vae features of images named like the
    latents pair with a DiT block."""
    root = tmp_path
    base = ["--latents", None, "--timestep", "0.5", "--batch", "5", "--device", "cpu"]
    dit = alignment_extract.main(["dit", "--config", rig["dit_cfg"], "--snapshot",
                                  dit_run["snapshots"][0], "--out", str(root / "dit"),
                                  *[a if a is not None else str(rig["dit"]["data"]["data_path"])
                                    for a in base]])
    reg = alignment_extract.main(["reg", "--config", rig["reg_cfg"], "--snapshot",
                                  reg_run["snapshots"][0], "--out", str(root / "reg"),
                                  *[a if a is not None else str(rig["reg"]["data"]["data_path"])
                                    for a in base]])
    assert set(dit) == {"embedder", "block_0", "block_1", "final_layer"}
    assert set(reg) == {"embedder", "block_0", "block_1", "final_layer", "projector_0"}
    f = np.load(reg["projector_0"])
    assert f["features"].shape == (N_LAT, FEAT_DIM) and np.isfinite(f["features"]).all()
    assert list(f["names"][:2]) == ["image_000000", "image_000001"]
    imgs = root / "imgs"
    imgs.mkdir()
    r = np.random.default_rng(0)
    for i in range(N_LAT):
        PIL.Image.fromarray(r.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            imgs / f"image_{i:06d}.png")
    vae = alignment_extract.main(["vae", "--config", rig["vae_cfg"], "--snapshot",
                                  rig["vae_snap"], "--images", str(imgs), "--out",
                                  str(root / "vae.npz"), "--resolution", "64", "--device", "cpu"])
    assert np.load(vae["features"])["features"].shape == (N_LAT, ZDIM)
    # A set against itself: HSIC / (HSIC + 1e-6), 1 but for the metric's own
    # 1e-6, which is not small beside the HSIC of the tiny rig's features.
    for a in (vae["features"], dit["block_1"]):
        f = torch.from_numpy(np.load(a)["features"])
        K = f @ f.T
        m = cknna._topk_mask(K, 3, True)
        hsic = float(cknna.hsic_unbiased(m * K, m * K))
        got = alignment_metrics.main(["--a", a, "--b", a, "--topk", "3"])
        assert abs(got - hsic / (hsic + 1e-6)) < 1e-6 and got > 0.5
    v = alignment_metrics.main(["--a", vae["features"], "--b", dit["block_1"], "--topk", "3",
                                "--normalize"])
    assert np.isfinite(v)
    assert np.isfinite(alignment_metrics.main(["--a", dit["block_0"], "--b", reg["projector_0"],
                                               "--topk", "3", "--biased"]))


def test_vfm_mode_serves_other_towers(tmp_path):
    """The vfm mode on a tiny DINOv2 (a local config.json with mlp_ratio):
    one row a image, the mean over the layer's patch tokens (the CLS token
    stripped) of the encoder the tool builds. tests/test_torch_towers.py
    holds it against JAX's extractor."""
    from vfm_vae_tpu_torch.models.vfm import VFMEncoder
    from vfm_vae_tpu_torch.tools._dit import init_model

    model = tmp_path / "dinov2-tiny"
    model.mkdir()
    (model / "config.json").write_text(json.dumps(dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=1.5,
        patch_size=8, image_size=32)))
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    r = np.random.default_rng(5)
    x = r.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    for i in range(2):
        PIL.Image.fromarray(x[i]).save(imgs / f"image_{i:06d}.png")
    out = alignment_extract.main(["vfm", "--model", str(model), "--images", str(imgs),
                                  "--out", str(tmp_path / "f"), "--resolution", "48",
                                  "--device", "cpu"])
    got = np.load(out["features"])["features"]
    enc = init_model(VFMEncoder(str(model), 1.0, [-1]), 0, "cpu")
    want = enc.encode_image(torch.from_numpy(x).float() / 255)[0]
    assert want.shape == (2, 36, 32) and got.shape == (2, 32)
    np.testing.assert_allclose(got, want.mean(1).numpy(), rtol=1e-6, atol=1e-6)


def test_trainers_refuse_several_processes(rig, monkeypatch):
    """Several processes are ported (tests/test_torch_distributed.py); a
    trainer told WORLD_SIZE=2 with no rendezvous to reach refuses to start
    rather than train alone as if it were the whole world."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    for tool, cfg in ((lightningdit_train, rig["dit_cfg"]), (reg_train, rig["reg_cfg"])):
        t0 = time.perf_counter()
        with pytest.raises(ValueError, match="MASTER_ADDR"):
            tool.main(["--config", cfg, "--device", "cpu"])
        assert time.perf_counter() - t0 < 60
        assert not torch.distributed.is_initialized()


def test_tools_need_the_card_unless_asked_for_the_cpu(rig, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools run on it")
    for tool, argv in ((lightningdit_train, ["--config", rig["dit_cfg"]]),
                       (reg_train, ["--config", rig["reg_cfg"]]),
                       (lightningdit_sample, ["--config", rig["dit_cfg"], "--dit-snapshot", "x",
                                              *rig["vae"], "--out", str(tmp_path)]),
                       (alignment_extract, ["dit", "--out", str(tmp_path)])):
        name = tool.__name__.rsplit(".", 1)[-1]
        with pytest.raises(SystemExit, match=f"{name}: no CUDA"):
            tool.main(argv)


@pytest.mark.parametrize("tool", DIT_TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_dit_tool_help(tool, capsys):
    with pytest.raises(SystemExit) as e:
        tool.main(["--help"] if tool is not alignment_preprocess else ["noise", "--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    assert "usage:" in text and not re.search(r"\b(TPU|v5e|v6e)\b", text)


def test_tool_configs_are_the_published_ones(rig):
    """The rig edits sizes and paths only: every other key is the YAML's."""
    with open(os.path.join(REPO, "tools/preprocess_for_reg/train_reg_sit_xl_1.yaml")) as f:
        pub = yaml.safe_load(f)
    cfg = tool_config(rig["reg_cfg"])
    assert cfg["optimizer"] == pub["optimizer"]
    assert {k: cfg["model"][k] for k in ("use_qknorm", "use_swiglu", "use_rope", "use_rmsnorm")} \
        == {k: pub["model"][k] for k in ("use_qknorm", "use_swiglu", "use_rope", "use_rmsnorm")}


@pytest.mark.parametrize("tool,mode", [(lightningdit_sample, "ode"), (reg_sample, "sde")],
                         ids=["lightningdit_sample", "reg_sample"])
def test_sampler_defaults_are_the_jax_tools(tool, mode):
    """The JAX REG sampler reuses the LightningDiT sampler's parser with
    --mode sde, so both samplers share its defaults (--steps 50 included)."""
    from vfm_vae_tpu_torch.tools._dit import sample_parser

    with open(os.path.join(REPO, "tools/preprocess_for_lightningdit/sample.py")) as f:
        src = f.read()
    want = {k.replace("-", "_"): v for k, v in re.findall(
        r'add_argument\("--([\w-]+)", type=\w+, default=([\d.]+)\)', src)}
    assert set(want) == {"num", "batch", "steps", "cfg"}
    required = ["--config", "c", "--dit-snapshot", "d", "--vae-config", "v", "--vae-snapshot",
                "s", "--out", "o"]
    args = vars(sample_parser(tool.__name__, mode).parse_args(required))
    assert {k: args[k] for k in want} == {k: type(args[k])(v) for k, v in want.items()}
    assert args["mode"] == mode
