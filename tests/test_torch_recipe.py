"""The four-stage training recipe through the port's CLI on the CPU
(vfm_vae_tpu_torch.train.cli), the counterpart of tests/test_stage_chain.py
for the port: each stage's YAML from configs/, cut to a tiny geometry, runs
`python -m vfm_vae_tpu_torch.train.cli --config ... --device cpu` in
process for one [D, G] step and ends on a snapshot; stage N + 1 resumes
stage N's. The plain PyTorch twins stand in for the kernels on the CPU.

The image is 64 px (z 8 px): at 32 px train_the_second_half_decoder, which
trains the blocks above 32 px, would train nothing. The SigLIP tower is
the tiny local config.json of tests/test_torch_train.py, DINO is tiny, the
shards are tests.test_data.make_shards', and the shuffle buffer is cut to
8 samples (the loader's default fills 4096 before its first batch).
Everything is fp32.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from tests.test_data import make_shards
from vfm_vae_tpu_torch.core.config import derive_config, load_config, to_plain
from vfm_vae_tpu_torch.train import cli
from vfm_vae_tpu_torch.train.checkpoint import load_snapshot
from vfm_vae_tpu_torch.train.loop import build_trainer, resume_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_YAMLS = [
    "vfm_vae_f16d32_siglip2_stage_0_strong_alignment.yaml",
    "vfm_vae_f16d32_siglip2_stage_1_weak_alignment.yaml",
    "vfm_vae_f16d32_siglip2_stage_2_ssim_ft.yaml",
    "vfm_vae_f16d32_siglip2_stage_3_patchgan_ft.yaml",
]
RES = 64
STEPS = 1
BATCH = 4
# G_kwargs that cut the flagship geometry of the YAMLs to the tiny one of
# __graft_entry__._tiny_g_kwargs (the rest, train_mode included, stays the
# YAML's).
TINY_G = dict(
    scale_factor=1.0, patch_from_layers=[0, 1, -1], patch_in_dimensions=[64, 64, 64],
    patch_out_dimensions=[16, 16, 16], decompress_factor=4, resolution_compression_factor=8,
    z_dimension=8, z_dim_for_mapping_mlp_output=64, concat_z_block_indices=[0, 1],
    concat_z_mapped_dims=[32, 16], attn_block_indices=[0], attn_depths=[1], num_blocks=4,
    num_fp16_res=0,
    synthesis_kwargs=dict(channel_base=4096, channel_max=64, num_res_blocks=1,
                          architecture="skip"),
)
TINY_DINO = dict(hidden_size=48, num_layers=2, num_heads=4, mlp_dim=96, patch_size=8,
                 image_size=32, hooks=[0, 1], hook_patch=True)


def write_siglip(d) -> str:
    os.makedirs(d, exist_ok=True)
    cfg = dict(model_type="siglip_vision_model", hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128, image_size=RES, patch_size=8,
               num_channels=3, layer_norm_eps=1e-6)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return str(d)


def stage_config(root, stage: int, resume_path=None):
    """Stage `stage`'s YAML with the tiny rig's overrides, derived as the CLI
    derives it (derive_config only fills keys that are missing)."""
    c = load_config(os.path.join(REPO, "configs", STAGE_YAMLS[stage]))
    c.run_dir = str(root / f"stage{stage}")
    c.G_kwargs.update(TINY_G, vfm_name=str(root / "siglip2-tiny-patch8-64"))
    c.D_kwargs["dino_kwargs"] = TINY_DINO
    c.training_set_kwargs.update(path=str(root / "shards"), resolution=RES,
                                 sample_shuffle_size=8)
    c.update(batch_size=BATCH, kimg_per_tick=1000, network_snapshot_ticks=1,
             image_snapshot_ticks=1, compute_dtype="float32", data_workers=1,
             allow_random_lpips=True, resume_path=resume_path, resume_kimg=0)
    return derive_config(c)


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


def run_cli(root, c, name: str, steps: int = STEPS):
    path = root / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(to_plain(c), f)
    return cli.main(["--config", str(path), "--max-steps", str(steps), "--device", "cpu"])


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    write_siglip(root / "siglip2-tiny-patch8-64")
    (root / "shards").mkdir()
    make_shards(root / "shards", n_shards=1, per_shard=16, size=72)
    return root


@pytest.fixture(scope="module")
def chain(rig):
    """Stages 0 -> 3 through the CLI, each resuming the previous snapshot;
    then the CLI again on stage 3's run_dir without resume_path."""
    results, snaps = [], []
    for stage in range(4):
        c = stage_config(rig, stage, snaps[-1] if snaps else None)
        results.append(run_cli(rig, c, f"stage{stage}"))
        snaps.append(results[-1].snapshot["path"])
    again = stage_config(rig, 3)
    again.resume_path = None
    auto = run_cli(rig, again, "stage3_again", steps=1)
    return dict(results=results, snaps=snaps, auto=auto,
                loaded=[load_snapshot(p) for p in snaps])


def trainable_set(result) -> set:
    return set(result.trainer.g_params)


def test_every_stage_resumes_its_predecessor(chain):
    res, snaps, loaded = chain["results"], chain["snaps"], chain["loaded"]
    assert res[0].resume is None
    for i in (1, 2, 3):
        assert res[i].resume["path"] == snaps[i - 1]
        # cur_nimg comes from the snapshot and goes on counting.
        assert res[i].state.cur_nimg == BATCH * STEPS * (i + 1)
        assert loaded[i]["cur_nimg"] == BATCH * STEPS * (i + 1)
    # The frozen tower, bit for bit through every handoff.
    tower = [k for k in loaded[0]["G"] if k.startswith("vfm_encoder.")]
    assert tower
    for i in (1, 2, 3):
        for k in tower:
            assert torch.equal(loaded[i - 1]["G"][k], loaded[i]["G"][k]), (i, k)
    # Stage 1 has stage 0's names and shapes: a strict load, nothing fresh.
    assert res[1].resume["strict"] and not res[1].resume["fresh"]


def test_stage_freezing(chain, rig):
    """Parameters outside each stage's trainable set are bit-identical
    before and after the stage; some trainable ones move."""
    res, loaded = chain["results"], chain["loaded"]
    fresh = build_trainer(**{k: stage_config(rig, 0)[k] for k in (
        "G_kwargs", "D_kwargs", "loss_kwargs", "G_opt_kwargs", "D_opt_kwargs")},
        device="cpu", compute_dtype="float32", allow_random_lpips=True)
    before = [fresh.G.state_dict()] + [s["G"] for s in loaded[:3]]
    for i in range(4):
        after, train = loaded[i]["G"], trainable_set(res[i])
        assert train
        params = [n for n, _ in res[i].trainer.G.named_parameters()]
        frozen = [k for k in params if k not in train and k in before[i]]
        for k in frozen:
            assert torch.equal(before[i][k], after[k]), f"stage {i}: frozen {k} changed"
        moved = [k for k in train if not torch.equal(before[i][k], after[k])]
        assert len(moved) > len(train) // 2, f"stage {i}: {len(moved)}/{len(train)} moved"
    # The sets themselves: the encoder side of the adapter freezes in stage
    # 2, and stage 3 trains only the one block above 32 px.
    assert any(k.startswith("ldm_adapter.final_quant") for k in trainable_set(res[1]))
    assert not any(k.startswith("ldm_adapter.final_quant") for k in trainable_set(res[2]))
    assert {k.split(".")[2] for k in trainable_set(res[3])} == {"3"}
    assert all(k.startswith("synthesis.blocks.3.") for k in trainable_set(res[3]))


def test_stage3_gains_patchgan_fresh(chain):
    res, loaded = chain["results"], chain["loaded"]
    pg = {n for n, _ in res[3].trainer.D.named_parameters() if n.startswith("patchgan.")}
    assert pg
    fresh_d = {k.split("/", 1)[1] for k in res[3].resume["fresh"] if k.startswith("D/")}
    assert fresh_d == pg
    assert not [k for k in res[3].resume["fresh"] if k.startswith(("G/", "G_ema/", "g_opt/"))]
    # DINO loads (and stays frozen); the heads load and go on training:
    # their Adam step counts carry over stage 2's.
    d2, d3 = loaded[2]["D"], loaded[3]["D"]
    for k in d2:
        if k.startswith("dino."):
            assert torch.equal(d2[k], d3[k]), k
    steps = {n: float(s["step"]) for n, s in loaded[3]["d_opt"].items()}
    assert all(steps[n] == STEPS for n in pg)
    heads = [n for n in steps if n.startswith("heads.")]
    assert heads and all(steps[n] == 4 * STEPS for n in heads)


def test_final_g_ema_round_trips(chain):
    G = chain["results"][3].trainer.G
    G.load_state_dict(chain["loaded"][3]["G_ema"])
    img = torch.rand((2, RES, RES, 3), generator=torch.Generator().manual_seed(0))
    out = G.decode(G.encode(img))
    assert out.shape == (2, RES, RES, 3) and torch.isfinite(out).all()


def test_second_call_auto_resumes(chain, rig):
    auto, snaps = chain["auto"], chain["snaps"]
    assert auto.resume["path"] == snaps[3] and auto.resume["strict"]
    with open(rig / "stage3" / "log.txt") as f:
        log = f.read()
    assert f"[auto-resume] found {snaps[3]}" in log
    # The same kimg: the snapshot is not written again.
    assert auto.snapshot["path"] == snaps[3]
    assert auto.state.cur_nimg == chain["results"][3].state.cur_nimg + BATCH
    with open(rig / "stage3" / "training_config.yaml") as f:
        assert yaml.safe_load(f)["resume_path"] == snaps[3]


def test_adam_state_merges_by_name_across_train_mode(chain, rig):
    """Stage 3's snapshot (train_the_second_half_decoder) resumed under
    stage 2's train_decoder: the parameters trainable in both keep their
    moments and step counts, the ones that become trainable start fresh."""
    c = stage_config(rig, 2)
    tr = build_trainer(**{k: c[k] for k in ("G_kwargs", "D_kwargs", "loss_kwargs",
                                            "G_opt_kwargs", "D_opt_kwargs")},
                       device="cpu", compute_dtype="float32", allow_random_lpips=True)
    state = tr.init_state()
    info = resume_from(tr, state, chain["snaps"][3])
    assert not info["strict"]
    saved = chain["loaded"][3]["g_opt"]
    carried = {n for n in tr.g_params if n in saved}
    assert carried == {n for n in tr.g_params if n.startswith("synthesis.blocks.3.")}
    for n, p in tr.g_params.items():
        st = state.g_opt.state.get(p)
        if n in carried:
            assert float(st["step"]) == float(saved[n]["step"]) == 4 * STEPS
            assert torch.equal(st["exp_avg_sq"], saved[n]["exp_avg_sq"])
        else:
            assert st is None, n
    assert {k.split("/")[1] for k in info["fresh"] if k.startswith("g_opt/")} == \
        set(tr.g_params) - carried
    # stage 3's D has PatchGAN, stage 2's does not: unexpected, not fresh.
    assert any(k.startswith("D/patchgan.") for k in info["unexpected"])


def test_cli_and_loop_refuse_what_is_unported(rig, tmp_path):
    c = stage_config(rig, 0)
    c.run_dir = str(tmp_path / "run")
    # (`metrics` is ported: tests/test_torch_tools.py runs recon_suite in the loop.)
    # (accumulate_gradients is ported: tests/test_torch_accumulation.py.)
    for key, value in (("fused_phases", True),):
        with pytest.raises(NotImplementedError, match=key):
            run_cli(tmp_path, dict(c, **{key: value}), key)
    # (The discriminator warm-ups are ported: tests/test_torch_warmup.py.)
    warm = stage_config(rig, 0)
    warm.run_dir = str(tmp_path / "run")
    warm.loss_kwargs["clip_loss_weight"] = 0.5
    with pytest.raises(NotImplementedError, match="clip_loss_weight"):
        run_cli(tmp_path, warm, "warm")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--config", str(tmp_path / "warm.yaml")])


def test_image_and_stats_outputs(chain, rig):
    for stage in range(4):
        run = rig / f"stage{stage}"
        assert (run / "train_samples" / "reals.png").is_file()
        assert (run / "train_samples" / "val_gens_000000.png").is_file()
        with open(run / "stats.jsonl") as f:
            entry = json.loads(f.readline())
        losses = {k: v for k, v in entry.items() if k.startswith("Loss/")}
        assert losses and all(np.isfinite(v) for v in losses.values()), stage
        if stage == 2:
            assert entry["Loss/G/ssim_loss"] > 0
        if stage == 3:
            assert entry["Loss/G/patchgan/loss"] > 0
            assert entry["Loss/G/patchgan/feature_matching_loss"] > 0
            assert "Loss/D/patchgan/loss" in entry
        if stage < 3:  # EQ regularisation on: the tally of drawn buckets
            assert sum(v for k, v in entry.items() if k.startswith("EQ/")) == 2 * STEPS
