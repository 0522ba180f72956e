"""Several processes for the port's training (vfm_vae_tpu_torch.parallel.mesh)
on the CPU: two gloo processes against one.

The two processes are started once for the module (subprocesses running
`worker`, one torch thread each) and meet through a FileStore under the
module's temporary directory, so that xdist workers cannot collide on a
port. The process group, every collective in it and the parent's wait for
each process have a timeout of their own: a hang fails the module's tests,
not the suite's clock. Each process writes what it saw to rank<r>.pt.

- The stage-0 [D, G] step at world 2 (8 images a process, a multiple of D's
  BatchNormLocal virtual_bs, so that D groups the images as at world 1)
  against the port at world 1 on the same 16 images, draws off.
  tests/test_torch_train.py holds the port's world-1 step against the JAX
  package, so this holds world 2 against JAX by transitivity. Both Adams
  run with eps = 1, so that the update is smooth in the gradient (see
  tests/test_torch_accumulation.py).
- The same step in discrete mode (the VQ with its entropy loss): the
  codebooks' usage EMAs and record counters equal on both processes and
  equal world 1's on the same global batch (the per-code counts are summed
  over the processes), and the parameters as above (the entropy loss's
  codebook term takes the global batch's mean probability).
- The safe-loss check sees the mean of the processes' terms: every
  process takes the same skip decision, whatever its own terms say.
- sync_across_processes sums the moments; check_replica_consistency
  passes, and names a tensor perturbed on one process.
- The loader's per-rank shards are disjoint and cover the set.
- The CLI at world 2 with accumulate_gradients 2: rank 0 alone writes the
  log, stats and snapshot; both processes resume from it.
- A LightningDiT step at world 2 against world 1 on the same global batch.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from tests.test_data import make_shards
from tests.test_torch_recipe import REPO, stage_config, write_siglip
from tests.torch_threads import one_torch_thread  # noqa: F401
from vfm_vae_tpu_torch.core.config import to_plain
from vfm_vae_tpu_torch.core.registry import construct_class_by_name

WORLD = 2
GLOBAL_BATCH = 16
RES = 64
TIMEOUT_S = 120  # the process group's collectives
JOIN_TIMEOUT_S = 300  # the parent's wait for each process
LINEAR_ADAM = dict(lr=1e-2, eps=1.0)
DIT_CFG = {"model": {"model_type": "LightningDiT-T/1"},
           "data": {"image_size": 64, "num_classes": 10}, "vae": {"downsample_ratio": 16}}
DIT_BATCH = 8


def step_config(root):
    """Stage 0's YAML at the tiny rig with linear Adams."""
    c = stage_config(root, 0)
    c.G_opt_kwargs.update(LINEAR_ADAM)
    c.D_opt_kwargs.update(LINEAR_ADAM)
    return c


def build(c):
    from vfm_vae_tpu_torch.train.loop import build_trainer

    return build_trainer(**{k: c[k] for k in ("G_kwargs", "D_kwargs", "loss_kwargs",
                                              "G_opt_kwargs", "D_opt_kwargs")},
                         device="cpu", compute_dtype="float32", allow_random_lpips=True,
                         batch_size=GLOBAL_BATCH)


def discrete_config(root):
    """step_config in discrete mode: four codebooks of 16 codes, 4 wide, the
    entropy loss on and weighted."""
    c = step_config(root)
    c.G_kwargs.update(compression_mode="discrete", vocab_width=16, vocab_size=64,
                      num_codebooks=4, use_entropy_loss=True)
    c.loss_kwargs.update(compression_mode="discrete", entropy_loss_weight=0.1)
    return c


def usage_buffers(G) -> dict:
    return {n: b.clone() for n, b in G.named_buffers() if ".quantizer." in n}


def global_batch():
    return torch.from_numpy(np.random.default_rng(7).random((GLOBAL_BATCH, RES, RES, 3))
                            .astype(np.float32))


def stage0_step(tr, real):
    """One [D, G] step (draws off) -> (state, G skip stat, trainable
    parameters and EMA on the host)."""
    state = tr.init_state()
    state, _, d_total = tr.d_step(state, real, (1.0, 0, False))
    state, g_stats, g_total = tr.g_step(state, real, (1.0, 0, False))
    params = {"G." + n: p.detach().clone() for n, p in tr.g_params.items()}
    params.update({"D." + n: p.detach().clone() for n, p in tr.d_params.items()})
    return dict(params=params, ema={n: e.clone() for n, e in state.ema.items()},
                skipped=g_stats["Loss/G/skipped"].clone(), cur_nimg=state.cur_nimg,
                totals=(float(d_total), float(g_total)))


def dit_step(z, y):
    """One LightningDiT-T step on the global batch -> (loss, gradients,
    parameters)."""
    from vfm_vae_tpu_torch.tools._dit import DiTTrainer, build_dit

    model = build_dit(DIT_CFG, "cpu")[0]
    tr = DiTTrainer(model, None, 2e-4, (0.9, 0.95), 0.0, True, True, 0.0,
                    torch.Generator().manual_seed(0))
    loss = tr.step(z, y)
    return dict(loss=float(loss),
                grads={n: p.grad.clone() for n, p in tr.net.named_parameters()},
                params={n: p.detach().clone() for n, p in tr.net.named_parameters()},
                trainer=tr)


def dit_batch():
    r = np.random.default_rng(11)
    return (torch.from_numpy(r.standard_normal((DIT_BATCH, 4, 4, 32)).astype(np.float32)),
            torch.from_numpy(r.integers(0, 10, DIT_BATCH)))


# ------------------------------------------------------------ the processes


def worker(rank: int, root: str) -> None:
    """One process of the world: every case in order, results to
    rank<rank>.pt (an "error" entry if a case raised)."""
    import datetime
    import traceback
    from pathlib import Path

    import torch.distributed as dist

    from vfm_vae_tpu_torch.core.stats import sync_across_processes
    from vfm_vae_tpu_torch.parallel import mesh
    from vfm_vae_tpu_torch.train import cli
    from vfm_vae_tpu_torch.train.loss import G_TERMS, G_TRACKED, LossState

    torch.set_num_threads(1)
    root = Path(root)
    out = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), WORLD),
                                rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out["rank_and_world"] = mesh.rank_and_world()

        tr = build(step_config(root))
        mesh.broadcast_modules([tr.G, tr.D])
        out["step"] = stage0_step(tr, mesh.rank_slice(global_batch()))
        mesh.check_replica_consistency(out["step"]["params"])
        tr = build(discrete_config(root))
        mesh.broadcast_modules([tr.G, tr.D])
        out["discrete"] = stage0_step(tr, mesh.rank_slice(global_batch()))
        out["discrete"]["usage"] = usage_buffers(tr.G)
        mesh.check_replica_consistency({**out["discrete"]["params"], **out["discrete"]["usage"]})

        # The safe-loss check on per-process terms: l1 1.0 here and 3.0 on
        # the other process; its previous value 0.25 makes 10x that 2.5, so
        # the mean 2.0 passes where rank 1's own 3.0 would not.
        terms = [torch.zeros(()) for _ in G_TERMS]
        terms[G_TERMS.index("l1_pixel_loss")] = torch.tensor(1.0 + 2.0 * rank)
        prev = torch.zeros(len(G_TRACKED))
        prev[G_TRACKED.index("l1_pixel_loss")] = 0.25
        skip, _, _ = tr.loss.g_safe(terms, LossState(prev, torch.tensor(True)), 1e9)
        out["skip"] = bool(skip)

        moments = {"a": torch.tensor([1.0, 2.0 + rank, 4.0]),
                   "b": torch.tensor([2.0, -1.0 * rank, 3.0])}
        out["synced"] = sync_across_processes(moments)

        named = {"a": torch.arange(6.0), "b": torch.ones(3, 2), "c": torch.zeros(2)}
        mesh.check_replica_consistency(named)
        named["b"] = named["b"] + (1e-7 if rank == 1 else 0.0)
        try:
            mesh.check_replica_consistency(named)
            out["perturbed"] = None
        except RuntimeError as e:
            out["perturbed"] = str(e)

        first = cli.main(["--config", str(root / "cli.yaml"), "--max-steps", "1",
                          "--device", "cpu"])
        again = cli.main(["--config", str(root / "cli.yaml"), "--max-steps", "1",
                          "--device", "cpu"])
        out["cli"] = dict(first=dict(resume=first.resume, snapshot=first.snapshot,
                                     cur_nimg=first.state.cur_nimg),
                          again=dict(resume=again.resume, snapshot=again.snapshot,
                                     cur_nimg=again.state.cur_nimg,
                                     remat=again.trainer.G.remat,
                                     n_acc=again.trainer.num_accumulation))

        d = dit_step(*dit_batch())
        mesh.check_replica_consistency({**d["params"], **{"ema." + n: e for n, e in
                                                          d["trainer"].ema.items()}})
        out["dit"] = {k: d[k] for k in ("loss", "grads", "params")}
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, root / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both processes' results, and the world-1 references computed here
    while they run."""
    root = tmp_path_factory.mktemp("world")
    write_siglip(root / "siglip2-tiny-patch8-64")
    (root / "shards").mkdir()
    make_shards(root / "shards", n_shards=WORLD, per_shard=8, size=72)
    c = stage_config(root, 0)
    c.run_dir = str(root / "run")
    c.update(batch_size=8, accumulate_gradients=2, data_workers=0)
    with open(root / "cli.yaml", "w") as f:
        yaml.safe_dump(to_plain(c), f)

    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"from tests.test_torch_distributed import worker; "
                               f"worker({r}, {str(root)!r})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        disc = build(discrete_config(root))
        ref = dict(step=stage0_step(build(step_config(root)), global_batch()),
                   discrete=stage0_step(disc, global_batch()), dit=dit_step(*dit_batch()))
        ref["discrete"]["usage"] = usage_buffers(disc.G)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(WORLD):
        path = root / f"rank{r}.pt"
        assert path.is_file(), f"rank {r} wrote no result (exit {procs[r].returncode}):\n" \
                               f"{logs[r][-4000:]}"
        res = torch.load(path, weights_only=False)
        assert "error" not in res, f"rank {r}:\n{res['error']}\n{logs[r][-4000:]}"
        results.append(res)
    return dict(root=root, ref=ref, results=results, logs=logs)


def test_ranks_joined_one_world(world):
    assert [r["rank_and_world"] for r in world["results"]] == [(0, WORLD), (1, WORLD)]


@pytest.mark.parametrize("case", ("step", "discrete"))
def test_world2_stage0_step_matches_world1(world, case):
    ref = world["ref"][case]
    assert ref["cur_nimg"] == GLOBAL_BATCH
    before = build((step_config if case == "step" else discrete_config)(world["root"]))
    start = {"G." + n: p.detach() for n, p in before.g_params.items()}
    start.update({"D." + n: p.detach() for n, p in before.d_params.items()})
    assert len(start) > 100
    for res in world["results"]:
        got = res[case]
        assert got["cur_nimg"] == GLOBAL_BATCH  # kimg accounting is global
        assert torch.equal(got["skipped"], ref["skipped"])
        np.testing.assert_allclose(got["totals"], ref["totals"], rtol=1e-5)
        for n in start:
            # The gradients' sums run in another order (two halves, then the
            # mean); the update is g / (|g| + 1) times lr.
            du, dw = got["params"][n] - start[n], ref["params"][n] - start[n]
            scale = float(dw.abs().max())
            atol = 1e-4 * scale + 4 * float(torch.finfo(torch.float32).eps
                                            * start[n].abs().max())
            torch.testing.assert_close(du, dw, rtol=0, atol=atol, msg=n)
            if n.startswith("G."):
                de = got["ema"][n[2:]] - start[n]
                torch.testing.assert_close(de, ref["ema"][n[2:]] - start[n], rtol=0, atol=atol,
                                           msg="ema " + n)
    # Replicas, bit for bit (the worker's check_replica_consistency passed too).
    a, b = (r[case]["params"] for r in world["results"])
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_world2_usage_buffers_match_world1(world):
    """The VQ usage EMAs after one [D, G] step (the G phase moves them once):
    equal on both processes, and world 1's on the same 16 images."""
    ref = world["ref"]["discrete"]["usage"]
    a, b = (r["discrete"]["usage"] for r in world["results"])
    assert sorted(ref) == sorted(a) and len(ref) == 8  # 4 codebooks x (EMA, counter)
    for n in ref:
        assert torch.equal(a[n], b[n]), n
        torch.testing.assert_close(a[n], ref[n], rtol=0, atol=1e-6, msg=n)
        if n.endswith("usage_record_times"):
            assert int(a[n]) == 1
        else:
            assert float(a[n].sum()) == pytest.approx(1.0)  # the first record: alpha 1


def test_skip_decision_is_the_worlds(world):
    # Rank 1's own l1 (3.0) is above 10x its previous value; the mean is not.
    assert [r["skip"] for r in world["results"]] == [False, False]


def test_sync_across_processes_sums_moments(world):
    for res in world["results"]:
        s = res["synced"]
        assert sorted(s) == ["a", "b"]
        assert torch.equal(s["a"], torch.tensor([2.0, 5.0, 8.0], dtype=torch.float64))
        assert torch.equal(s["b"], torch.tensor([4.0, -1.0, 6.0], dtype=torch.float64))


def test_replica_check_names_a_perturbed_tensor(world):
    for res in world["results"]:
        assert res["perturbed"] is not None and "'b'" in res["perturbed"]
        assert "'a'" not in res["perturbed"] and "'c'" not in res["perturbed"]


def test_loader_shards_split_by_rank(world):
    """Each rank reads its own shards (shard r of 2): the images the two
    ranks draw are disjoint, and together they are every image (without
    augmentation, so that an image decodes to the same bytes every time)."""
    kwargs = dict(stage_config(world["root"], 0).training_set_kwargs, data_augmentation=False)

    def drawn(num_processes, rank, batches):
        ds = construct_class_by_name(**kwargs)
        it = ds.loader(batch_size=4, workers=0, base_seed=0, num_processes=num_processes,
                       process_index=rank)
        seen = set()
        for _ in range(batches):
            imgs, _ = next(it)
            seen |= {img.tobytes() for img in imgs}
        it.close()
        return seen

    every = drawn(1, 0, 12)
    assert len(every) == 8 * WORLD
    parts = [drawn(WORLD, r, 6) for r in range(WORLD)]
    assert not parts[0] & parts[1]
    assert parts[0] | parts[1] == every


def test_cli_rank0_writes_and_both_resume(world):
    run = world["root"] / "run"
    snaps = sorted(p for p in os.listdir(run) if p.startswith("network-snapshot-"))
    assert snaps == ["network-snapshot-00000000"]
    path = str(run / snaps[0])
    with open(run / "stats.jsonl") as f:
        lines = f.read().splitlines()
    assert len(lines) == 2  # one tick a call, from rank 0 alone
    with open(run / "log.txt") as f:
        log = f.read()
    assert log.count("[batch] 8 images a step: 2 process(es) x 2 microbatch(es) of 2; "
                     "remat 'dots'") == 2
    assert "replica consistency OK (2 processes)" in log
    for res in world["results"]:
        cli = res["cli"]
        assert cli["first"]["resume"] is None and cli["first"]["cur_nimg"] == 8
        assert cli["first"]["snapshot"]["path"] == path
        assert cli["again"]["resume"]["path"] == path and cli["again"]["resume"]["strict"]
        assert cli["again"]["cur_nimg"] == 16
        assert cli["again"]["remat"] == "dots" and cli["again"]["n_acc"] == 2


def test_world2_dit_step_matches_world1(world):
    ref = world["ref"]["dit"]
    for res in world["results"]:
        got = res["dit"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert len(got["grads"]) > 10
        for n, g in got["grads"].items():
            scale = float(ref["grads"][n].abs().max())
            torch.testing.assert_close(g, ref["grads"][n], rtol=0, atol=1e-5 * scale + 1e-12,
                                       msg=n)
    a, b = (r["dit"]["params"] for r in world["results"])
    assert all(torch.equal(a[n], b[n]) for n in a)
